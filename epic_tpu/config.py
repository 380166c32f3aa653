"""Typed configuration for the solver stack (SURVEY §5 "config/flag system").

The reference's configuration surface is ROS parameters + keyword defaults
scattered across launch files (epic_navigation_node_main.cpp:43-68,
launch/*.launch). Here it is one dataclass tree covering solver numerics,
kernel selection, mesh shape, and service endpoints. PlannerConfig
(epic_tpu.planner) embeds SolverConfig semantics for the anytime node.
"""

from __future__ import annotations

import dataclasses

from . import constants as C


@dataclasses.dataclass
class SolverConfig:
    """Numerics + kernel selection."""

    epsilon: float = C.DEFAULT_EPSILON_NODE
    stagger: int = C.DEFAULT_STAGGER
    max_iterations: int = 1_000_000
    # backend: which compute path relaxes the grid (solver.route): "auto"
    # runs the CUDA sweep kernel for 2D grids on a GPU and XLA elsewhere.
    backend: str = "auto"            # "auto" | "xla" | "cuda"
    # kernel: the stencil layout; the masked full-grid update is the only one.
    kernel: str = "masked"           # "masked"
    # Opt-in coarse-to-fine warm start for blocking solves (solver.cascade):
    # same convergence certificate, fewer fine-grid sweeps on open domains.
    cascade: bool = False


@dataclasses.dataclass
class MeshConfig:
    """Multi-chip decomposition (epic_tpu.parallel)."""

    shape: tuple[int, int] | None = None   # None -> near-square over devices
    axis_names: tuple[str, str] = ("my", "mx")


@dataclasses.dataclass
class ServiceConfig:
    """Service-plane endpoints (epic_tpu.services.server)."""

    host: str = "127.0.0.1"
    port: int = 7171
    steps_per_update: int = 50
    update_rate_hz: float = 10.0


@dataclasses.dataclass
class VizConfig:
    """Display profile — the declarative analog of the reference's rviz
    view config (rviz/default.rviz wired by
    launch/epic_navigation_node_umass.launch:26): what the demos and the
    interactive session render and how streamlines are walked. Consumed
    by ``tools/anytime_demo.py`` and :mod:`epic_tpu.viz` callers."""

    show_field: bool = True          # False: draw over the original map
    interpolation: str = "bilinear"  # path walker mode ("reference" quirk-faithful)
    starts: int = 6                  # demo sample start points


@dataclasses.dataclass
class EpicConfig:
    """The full configuration tree. Consumed by :class:`epic_tpu.planner.
    Planner` (pass it in place of a PlannerConfig), the service-server CLI
    (``python -m epic_tpu.services.server``), and ``tools/batch_bench.py``.

    Serializable to/from YAML session files (``configs/*.yaml``) — the
    declarative analog of the reference's per-map launch tuning
    (launch/epic_navigation_node_umass.launch:8-23 carries map_name +
    steps_per_update/update_rate per map; here the same knobs live in a
    checked-in config file instead of code defaults)."""

    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    service: ServiceConfig = dataclasses.field(default_factory=ServiceConfig)
    viz: VizConfig = dataclasses.field(default_factory=VizConfig)
    # Startup map: a map_server YAML or PNG path. ``${VAR}`` env refs are
    # expanded at resolve time; relative paths resolve against the config
    # file's directory first, then maps.reference_map_path.
    map: str | None = None

    # -- serialization ----------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "EpicConfig":
        d = dict(d)
        sections = {}
        for name, sub_cls in (("solver", SolverConfig), ("mesh", MeshConfig),
                              ("service", ServiceConfig),
                              ("viz", VizConfig)):
            sub = d.pop(name, None) or {}
            fields = {f.name for f in dataclasses.fields(sub_cls)}
            unknown = set(sub) - fields
            if unknown:
                raise ValueError(
                    f"unknown {name} config keys: {sorted(unknown)}")
            sections[name] = sub_cls(**sub)
        if sections["mesh"].shape is not None:
            sections["mesh"].shape = tuple(sections["mesh"].shape)
        sections["mesh"].axis_names = tuple(sections["mesh"].axis_names)
        map_path = d.pop("map", None)
        if d:
            raise ValueError(f"unknown config keys: {sorted(d)}")
        return cls(map=map_path, **sections)

    def save_yaml(self, path) -> None:
        import yaml

        d = self.to_dict()
        if d.get("map") is None:
            d.pop("map", None)
        with open(path, "w") as f:
            yaml.safe_dump(d, f, sort_keys=False)

    @classmethod
    def load_yaml(cls, path) -> "EpicConfig":
        import pathlib

        import yaml

        path = pathlib.Path(path)
        with open(path) as f:
            d = yaml.safe_load(f) or {}
        cfg = cls.from_dict(d)
        cfg._config_dir = path.parent   # for relative map resolution
        cfg._config_path = path.resolve()
        return cfg

    def resolve_map_path(self):
        """Resolve :attr:`map` to an existing file path, or None.

        Order: env-var expansion, absolute path, path relative to the
        config file's directory, then the reference fixture search
        (:func:`epic_tpu.maps.reference_map_path`). Raises FileNotFoundError
        for a configured map that resolves nowhere."""
        import os
        import pathlib

        if self.map is None:
            return None
        p = pathlib.Path(os.path.expandvars(self.map))
        if p.is_absolute():
            if p.exists():
                return p
        else:
            base = getattr(self, "_config_dir", pathlib.Path("."))
            cand = base / p
            # Guard the name collision: a session config whose ``map`` is
            # a bare name like "maze.yaml" must not resolve to the config
            # file ITSELF (both live in configs/).
            self_path = getattr(self, "_config_path", None)
            if cand.exists() and (self_path is None
                                  or cand.resolve() != self_path):
                return cand
            from . import maps

            ref = maps.reference_map_path(str(p)) or maps.reference_map_path(
                p.name)
            if ref is not None:
                return ref
        raise FileNotFoundError(f"configured map not found: {self.map}")
