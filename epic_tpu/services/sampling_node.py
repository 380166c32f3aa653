"""Sampling-based navigation node — the reference's OMPL node, completed.

The reference ships an OMPL-backed alternative to the harmonic node
(src/epic_navigation_node_ompl.cpp, include/epic/epic_navigation_node_ompl.h)
but never builds it (CMakeLists.txt:56 comments it out) and never finished
it: only RRT-Connect of its six algorithm enum slots is constructed
(epic_navigation_node_ompl.cpp:166-169) and srvComputePath's path population
is a TODO (epic_navigation_node_ompl.cpp:433-441). This module implements a
*working* equivalent with the same surface and semantics, self-contained
(no OMPL dependency — planners in NumPy; the service plane, not the accelerator, is
the right home for sequential tree search):

- same verb set: occupancy ingest, add_goals / remove_goals (exactly ONE
  goal, epic_navigation_node_ompl.cpp:303-307), set_cells, compute_path
  (no get_cell / set_status / reset_free_cells — the reference's OMPL node
  does not advertise them, :91-101);
- same state machine: map → single goal → first compute_path assigns the
  start and constructs the planner (initAlg, :128-174); ``update(t)``
  grows the search for a time budget like ``ompl_planner->solve(t)``
  (:110-119); map changes reset the algorithm (:263);
- same occupancy semantics as the harmonic node: >= 50 → obstacle,
  NO_CHANGE untouched, boundary ring forced obstacle (:250-287);
- same validity model: a continuous state (x, y) ∈ [0, W) × [0, H) is valid
  iff its containing cell is not an obstacle (the state validity checker
  the reference sketches); motions are checked by segment sampling at
  half-cell resolution;
- algorithms: ALL SIX of the reference's enum slots
  (epic_navigation_node_ompl.h:47-53) are constructed — RRT_CONNECT (the
  only one the reference ever built, :166-169), RRT_STAR (the optimizing
  planner its PathLengthOptimizationObjective points at, :122-126),
  LAZY_RRT (unvalidated growth + lazy branch validation with subtree
  pruning), and the PRM family: PRM_STAR (eager edges, shrinking
  r(n) ~ sqrt(log n / n) connection radius), LAZY_PRM (unvalidated edges,
  fixed radius, validate-on-candidate-path), LAZY_PRM_STAR (lazy edges on
  the star schedule).

ComputePath — the part the reference left TODO — returns the best path
found so far with the harmonic node's pose conventions: first pose is the
request's start verbatim, yaw from atan2 of each segment
(epic_navigation_node_ompl.cpp:443-462 sketches exactly this loop).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np

from .. import constants as C
from . import messages as msg

# Algorithm enum (epic_navigation_node_ompl.h:47-53).
ALGORITHM_RRT_CONNECT = 0
ALGORITHM_RRT_STAR = 1
ALGORITHM_LAZY_RRT = 2
ALGORITHM_LAZY_PRM = 3
ALGORITHM_PRM_STAR = 4
ALGORITHM_LAZY_PRM_STAR = 5
NUM_ALGORITHMS = 6

_IMPLEMENTED = {
    ALGORITHM_RRT_CONNECT, ALGORITHM_RRT_STAR, ALGORITHM_LAZY_RRT,
    ALGORITHM_LAZY_PRM, ALGORITHM_PRM_STAR, ALGORITHM_LAZY_PRM_STAR,
}
_PRM_FAMILY = {ALGORITHM_LAZY_PRM, ALGORITHM_PRM_STAR,
               ALGORITHM_LAZY_PRM_STAR}


class _Tree:
    """A growable point tree with vectorized nearest-neighbour queries.

    ``active`` supports LazyRRT's repair step: when lazy validation finds
    an invalid edge, the child's whole subtree is disabled (OMPL's
    LazyRRT::removeMotion) and excluded from nearest/near queries."""

    def __init__(self, root: np.ndarray, capacity: int = 1024):
        self.pts = np.empty((capacity, 2), dtype=np.float64)
        self.parent = np.empty(capacity, dtype=np.int64)
        self.cost = np.empty(capacity, dtype=np.float64)
        self.active = np.empty(capacity, dtype=bool)
        self.n = 1
        self.pts[0] = root
        self.parent[0] = -1
        self.cost[0] = 0.0
        self.active[0] = True

    def _grow(self) -> None:
        cap = self.pts.shape[0] * 2
        self.pts = np.resize(self.pts, (cap, 2))
        self.parent = np.resize(self.parent, cap)
        self.cost = np.resize(self.cost, cap)
        self.active = np.resize(self.active, cap)

    def add(self, pt: np.ndarray, parent: int, cost: float) -> int:
        if self.n == self.pts.shape[0]:
            self._grow()
        i = self.n
        self.pts[i] = pt
        self.parent[i] = parent
        self.cost[i] = cost
        self.active[i] = True
        self.n += 1
        return i

    def nearest(self, q: np.ndarray) -> int:
        d = self.pts[: self.n] - q
        dd = np.einsum("ij,ij->i", d, d)
        dd[~self.active[: self.n]] = np.inf
        return int(np.argmin(dd))

    def near(self, q: np.ndarray, radius: float) -> np.ndarray:
        d = self.pts[: self.n] - q
        hit = np.einsum("ij,ij->i", d, d) <= radius * radius
        return np.nonzero(hit & self.active[: self.n])[0]

    def path_to_root(self, i: int) -> list[np.ndarray]:
        out = []
        while i >= 0:
            out.append(self.pts[i].copy())
            i = int(self.parent[i])
        return out

    def nodes_to_root(self, i: int) -> list[int]:
        out = []
        while i >= 0:
            out.append(i)
            i = int(self.parent[i])
        return out

    def disable_subtree(self, root: int) -> None:
        kill = {root}
        self.active[root] = False
        # One forward pass suffices: children always have larger indices.
        for j in range(root + 1, self.n):
            if self.active[j] and int(self.parent[j]) in kill:
                self.active[j] = False
                kill.add(j)


class _Roadmap:
    """An undirected weighted graph over sampled configurations (the PRM
    family's data structure): adjacency dicts + a validated-edge set for
    the lazy variants."""

    def __init__(self, start: np.ndarray, goal: np.ndarray):
        self.pts = np.empty((1024, 2), dtype=np.float64)
        self.pts[0] = start
        self.pts[1] = goal
        self.n = 2
        self.adj: list[dict[int, float]] = [{}, {}]
        self.validated: set[tuple[int, int]] = set()

    def add(self, pt: np.ndarray) -> int:
        if self.n == self.pts.shape[0]:
            self.pts = np.resize(self.pts, (self.pts.shape[0] * 2, 2))
        i = self.n
        self.pts[i] = pt
        self.adj.append({})
        self.n += 1
        return i

    def near(self, q: np.ndarray, radius: float) -> np.ndarray:
        d = self.pts[: self.n] - q
        return np.nonzero(np.einsum("ij,ij->i", d, d) <= radius * radius)[0]

    def connect(self, i: int, j: int, w: float) -> None:
        self.adj[i][j] = w
        self.adj[j][i] = w

    def drop_edge(self, i: int, j: int) -> None:
        self.adj[i].pop(j, None)
        self.adj[j].pop(i, None)

    def shortest_path(self, src: int = 0, dst: int = 1) -> list[int] | None:
        """Dijkstra over the current adjacency; None when disconnected."""
        import heapq

        dist = {src: 0.0}
        prev: dict[int, int] = {}
        heap = [(0.0, src)]
        seen: set[int] = set()
        while heap:
            d, i = heapq.heappop(heap)
            if i in seen:
                continue
            if i == dst:
                path = [dst]
                while path[-1] != src:
                    path.append(prev[path[-1]])
                return path[::-1]
            seen.add(i)
            for j, w in self.adj[i].items():
                nd = d + w
                if nd < dist.get(j, math.inf):
                    dist[j] = nd
                    prev[j] = i
                    heapq.heappush(heap, (nd, j))
        return None


@dataclass
class _Problem:
    """Frozen at initAlg time, like the reference handing the occupancy grid
    to its validity checker (epic_navigation_node_ompl.cpp:150-153)."""

    obstacle: np.ndarray          # bool [H, W]
    start: np.ndarray             # float (x, y) map coords
    goal: np.ndarray
    rng: np.random.Generator = field(default_factory=np.random.default_rng)


class SamplingPlanner:
    """The planning core (OMPL stand-in): anytime tree search over the
    occupancy grid. All coordinates here are continuous map ("float pixel")
    coordinates; the node layer handles world transforms."""

    def __init__(
        self,
        algorithm: int = ALGORITHM_RRT_CONNECT,
        range_: float | None = None,
        goal_tolerance: float = 1e-6,
        seed: int | None = None,
    ):
        if not (0 <= algorithm < NUM_ALGORITHMS):
            raise ValueError(f"unknown algorithm {algorithm}")
        assert algorithm in _IMPLEMENTED  # all six enum slots are built
        self.algorithm = algorithm
        self.range = range_
        self.goal_tolerance = goal_tolerance
        self._seed = seed
        self.prob: _Problem | None = None
        self._trees: tuple[_Tree, _Tree] | None = None
        self._roadmap: _Roadmap | None = None
        self._lazy_validated: set[int] = set()
        self._solution: np.ndarray | None = None   # [N, 2] map coords
        self._solved = False
        self.iterations = 0

    # -- setup ------------------------------------------------------------

    def setup(self, obstacle: np.ndarray, start, goal) -> None:
        obstacle = np.asarray(obstacle, dtype=bool)
        start = np.asarray(start, dtype=np.float64)
        goal = np.asarray(goal, dtype=np.float64)
        self.prob = _Problem(
            obstacle=obstacle,
            start=start,
            goal=goal,
            rng=np.random.default_rng(self._seed),
        )
        if self.range is None:
            # OMPL's SelfConfig::configurePlannerRange: 20% of the space's
            # maximum extent.
            h, w = obstacle.shape
            self.range = 0.2 * math.hypot(w, h)
        self._trees = (_Tree(start), _Tree(goal))
        self._roadmap = (_Roadmap(start, goal)
                         if self.algorithm in _PRM_FAMILY else None)
        self._lazy_validated = set()
        self._solution = None
        self._solved = False
        self.iterations = 0
        if not self._state_valid(start):
            raise ValueError("start state is in collision")
        if not self._state_valid(goal):
            raise ValueError("goal state is in collision")

    # -- validity ----------------------------------------------------------

    def _state_valid(self, p: np.ndarray) -> bool:
        prob = self.prob
        h, w = prob.obstacle.shape
        x, y = p
        if not (0.0 <= x < w and 0.0 <= y < h):
            return False
        return not prob.obstacle[int(y), int(x)]

    def _motion_valid(self, a: np.ndarray, b: np.ndarray) -> bool:
        """Discrete motion validation at half-cell resolution (OMPL's
        DiscreteMotionValidator with the state space's default segment
        count); endpoints included."""
        n = max(2, int(math.ceil(np.linalg.norm(b - a) / 0.5)) + 1)
        ts = np.linspace(0.0, 1.0, n)[:, None]
        pts = a[None, :] + ts * (b - a)[None, :]
        prob = self.prob
        h, w = prob.obstacle.shape
        xs = pts[:, 0]
        ys = pts[:, 1]
        if (xs < 0).any() or (ys < 0).any() or (xs >= w).any() or (ys >= h).any():
            return False
        return not prob.obstacle[ys.astype(int), xs.astype(int)].any()

    # -- anytime solve ------------------------------------------------------

    def solve(self, budget_s: float | None = None,
              iterations: int | None = None) -> bool:
        """Grow the search, like ompl_planner->solve(t)
        (epic_navigation_node_ompl.cpp:118). Returns True if a solution
        exists after the budget. The non-optimizing planners (RRT-Connect,
        LazyRRT) stop improving once solved; the optimizing ones (RRT*,
        PRM*, LazyPRM*) keep refining for the whole budget (path-length
        objective, :122-126). The lazy planners validate motions only on
        candidate solution paths."""
        if self.prob is None:
            raise RuntimeError("setup() has not been called")
        t_end = None if budget_s is None else time.monotonic() + budget_s
        it_end = None if iterations is None else self.iterations + iterations
        if t_end is None and it_end is None:
            it_end = self.iterations + 1000
        non_optimizing = self.algorithm in (ALGORITHM_RRT_CONNECT,
                                            ALGORITHM_LAZY_RRT)
        while True:
            if t_end is not None and time.monotonic() >= t_end:
                break
            if it_end is not None and self.iterations >= it_end:
                break
            if self._solved and non_optimizing:
                break
            self.iterations += 1
            if self.algorithm == ALGORITHM_RRT_CONNECT:
                self._step_rrt_connect()
            elif self.algorithm == ALGORITHM_RRT_STAR:
                self._step_rrt_star()
            elif self.algorithm == ALGORITHM_LAZY_RRT:
                self._step_lazy_rrt()
            else:
                self._step_prm()
        if self.algorithm in _PRM_FAMILY:
            self._extract_prm_solution()
        return self._solved

    @property
    def solved(self) -> bool:
        return self._solved

    def solution_path(self) -> np.ndarray | None:
        """Best path found so far, [N, 2] float map coords (start..goal)."""
        return None if self._solution is None else self._solution.copy()

    # -- RRT-Connect --------------------------------------------------------

    def _sample(self) -> np.ndarray:
        h, w = self.prob.obstacle.shape
        r = self.prob.rng.random(2)
        return np.array([r[0] * w, r[1] * h])

    def _steer(self, frm: np.ndarray, to: np.ndarray) -> np.ndarray:
        d = to - frm
        dist = float(np.linalg.norm(d))
        if dist <= self.range:
            return to
        return frm + d * (self.range / dist)

    def _extend(self, tree: _Tree, q: np.ndarray) -> tuple[int, bool]:
        """One EXTEND: returns (new node index or -1, reached_q)."""
        i = tree.nearest(q)
        new = self._steer(tree.pts[i], q)
        if not self._motion_valid(tree.pts[i], new):
            return -1, False
        cost = tree.cost[i] + float(np.linalg.norm(new - tree.pts[i]))
        j = tree.add(new, i, cost)
        return j, bool(np.allclose(new, q))

    def _step_rrt_connect(self) -> None:
        ta, tb = self._trees
        q = self._sample()
        j, _ = self._extend(ta, q)
        if j >= 0:
            # CONNECT the other tree toward the new node.
            target = ta.pts[j]
            while True:
                k, reached = self._extend(tb, target)
                if k < 0:
                    break
                if reached:
                    self._record_connect_solution(ta, j, tb, k)
                    break
        # Swap trees each iteration (RRT-Connect's balancing).
        self._trees = (tb, ta)

    def _record_connect_solution(self, ta: _Tree, j: int, tb: _Tree, k: int):
        seg_a = ta.path_to_root(j)[::-1]   # root..j
        seg_b = tb.path_to_root(k)         # k..root
        pts = np.asarray(seg_a + seg_b)
        # Orient start -> goal regardless of which tree is currently "a".
        if np.linalg.norm(pts[0] - self.prob.start) > 1e-9:
            pts = pts[::-1]
        new_len = float(np.linalg.norm(np.diff(pts, axis=0), axis=1).sum())
        if self._solution is None or new_len < self._path_len(self._solution):
            self._solution = pts
        self._solved = True

    @staticmethod
    def _path_len(pts: np.ndarray) -> float:
        return float(np.linalg.norm(np.diff(pts, axis=0), axis=1).sum())

    # -- RRT* ---------------------------------------------------------------

    def _step_rrt_star(self) -> None:
        tree = self._trees[0]
        # 5% goal bias (OMPL RRTstar default goal_bias 0.05).
        if self.prob.rng.random() < 0.05:
            q = self.prob.goal.copy()
        else:
            q = self._sample()
        i = tree.nearest(q)
        new = self._steer(tree.pts[i], q)
        if not self._state_valid(new) or not self._motion_valid(tree.pts[i], new):
            return
        # RRT* rewiring radius: min(range, gamma * (log n / n)^(1/d)).
        n = tree.n
        radius = min(self.range * 2.0,
                     self.range * 4.0 * math.sqrt(math.log(n + 1) / (n + 1)) + 1e-9)
        radius = max(radius, self.range * 0.5)
        near = tree.near(new, radius)
        # Choose best parent among near nodes.
        best_i, best_cost = i, tree.cost[i] + float(np.linalg.norm(new - tree.pts[i]))
        for m in near:
            c = tree.cost[m] + float(np.linalg.norm(new - tree.pts[m]))
            if c < best_cost and self._motion_valid(tree.pts[m], new):
                best_i, best_cost = int(m), c
        j = tree.add(new, best_i, best_cost)
        # Rewire near nodes through the new node when cheaper.
        for m in near:
            c = best_cost + float(np.linalg.norm(tree.pts[m] - new))
            if c < tree.cost[m] and self._motion_valid(new, tree.pts[m]):
                tree.parent[m] = j
                tree.cost[m] = c
        # Try to connect to goal.
        if (
            np.linalg.norm(new - self.prob.goal) <= self.range
            and self._motion_valid(new, self.prob.goal)
        ):
            pts = np.asarray(tree.path_to_root(j)[::-1] + [self.prob.goal.copy()])
            if self._solution is None or self._path_len(pts) < self._path_len(self._solution):
                self._solution = pts
            self._solved = True

    # -- LazyRRT ------------------------------------------------------------

    def _step_lazy_rrt(self) -> None:
        """OMPL LazyRRT: grow WITHOUT motion validation; when the tree
        reaches the goal, validate the candidate branch lazily and prune
        the subtree below the first invalid edge (removeMotion)."""
        tree = self._trees[0]
        if self.prob.rng.random() < 0.05:
            q = self.prob.goal.copy()
        else:
            q = self._sample()
        i = tree.nearest(q)
        new = self._steer(tree.pts[i], q)
        if not self._state_valid(new):
            return
        j = tree.add(new, i, tree.cost[i] + float(np.linalg.norm(new - tree.pts[i])))
        if np.linalg.norm(new - self.prob.goal) > self.goal_tolerance:
            if (np.linalg.norm(new - self.prob.goal) <= self.range
                    and self._state_valid(self.prob.goal)):
                j = tree.add(self.prob.goal.copy(), j,
                             tree.cost[j] + float(np.linalg.norm(
                                 self.prob.goal - new)))
            else:
                return
        # Candidate branch root..goal: validate unvalidated edges
        # (_lazy_validated holds child nodes whose parent edge checked out).
        nodes = tree.nodes_to_root(j)[::-1]
        for a, b in zip(nodes, nodes[1:]):
            if b in self._lazy_validated:
                continue
            if self._motion_valid(tree.pts[a], tree.pts[b]):
                self._lazy_validated.add(b)
            else:
                tree.disable_subtree(b)
                return
        pts = np.asarray([tree.pts[i_].copy() for i_ in nodes])
        if self._solution is None or self._path_len(pts) < self._path_len(self._solution):
            self._solution = pts
        self._solved = True

    # -- PRM family ----------------------------------------------------------

    def _prm_radius(self) -> float:
        """Connection radius. LazyPRM keeps the planner range (OMPL's
        default connection strategy); the star variants shrink it as
        r(n) ~ sqrt(log n / n) (PRM*'s asymptotic-optimality schedule),
        floored at half the range so sparse early graphs still connect."""
        if self.algorithm == ALGORITHM_LAZY_PRM:
            return self.range
        n = self._roadmap.n
        r = self.range * 4.0 * math.sqrt(math.log(n + 1) / (n + 1))
        return float(np.clip(r, self.range * 0.5, self.range * 2.0))

    # Degree bound for roadmap connections (OMPL's KStrategy: PRM* uses
    # k ~ e(1+1/d) log n; a fixed small k keeps the lazy repair loop's
    # Dijkstra-per-dropped-edge cost bounded — an unbounded radius disc
    # connects O(n) neighbours per sample and the edge count explodes
    # quadratically).
    PRM_MAX_DEGREE = 12

    def _step_prm(self) -> None:
        """Sample one valid configuration and connect it to its nearest
        neighbours (at most PRM_MAX_DEGREE within the connection radius).
        PRM* validates motions eagerly at insertion; the lazy variants
        insert edges unchecked (validation happens on candidate solution
        paths in :func:`_extract_prm_solution`)."""
        rm = self._roadmap
        p = self._sample()
        if not self._state_valid(p):
            return
        lazy = self.algorithm != ALGORITHM_PRM_STAR
        radius = self._prm_radius()
        near = rm.near(p, radius)
        if len(near) > self.PRM_MAX_DEGREE:
            d2 = np.einsum("ij,ij->i", rm.pts[near] - p, rm.pts[near] - p)
            near = near[np.argsort(d2)[: self.PRM_MAX_DEGREE]]
        i = rm.add(p)
        for m in near:
            m = int(m)
            w = float(np.linalg.norm(rm.pts[m] - p))
            if lazy:
                rm.connect(i, m, w)
            elif self._motion_valid(rm.pts[m], p):
                rm.connect(i, m, w)
                rm.validated.add((min(i, m), max(i, m)))

    def _extract_prm_solution(self) -> None:
        """Shortest roadmap path start->goal; lazy variants validate its
        edges and drop invalid ones, re-searching until a fully validated
        path survives or the graph disconnects (OMPL LazyPRM's
        checkForSolution loop)."""
        rm = self._roadmap
        while True:
            nodes = rm.shortest_path()
            if nodes is None:
                return
            ok = True
            for a, b in zip(nodes, nodes[1:]):
                key = (min(a, b), max(a, b))
                if key in rm.validated:
                    continue
                if self._motion_valid(rm.pts[a], rm.pts[b]):
                    rm.validated.add(key)
                else:
                    rm.drop_edge(a, b)
                    ok = False
                    break
            if ok:
                pts = np.asarray([rm.pts[i].copy() for i in nodes])
                if (self._solution is None
                        or self._path_len(pts) < self._path_len(self._solution)):
                    self._solution = pts
                self._solved = True
                return


class EpicNavigationNodeSampling:
    """The node: reference verb surface over :class:`SamplingPlanner`
    (epic_navigation_node_ompl.cpp). Single goal, single start; the planner
    is (re)constructed lazily by compute_path once map + goal + start exist
    (initAlg preconditions, :131-133)."""

    def __init__(self, algorithm: int = ALGORITHM_RRT_CONNECT,
                 seed: int | None = None, range_: float | None = None):
        self.algorithm = algorithm
        self._seed = seed
        self._range = range_
        self.planner: SamplingPlanner | None = None
        self.obstacle: np.ndarray | None = None   # bool [H, W]
        self.width = 0
        self.height = 0
        self.resolution = 1.0
        self.x_origin = 0.0
        self.y_origin = 0.0
        self.goal: tuple[float, float] | None = None      # map coords
        self.start: tuple[float, float] | None = None

    # -- transforms (epic_navigation_node_ompl.cpp:207-225) ----------------

    def map_to_world(self, mx: float, my: float) -> tuple[float, float]:
        return (self.x_origin + mx * self.resolution,
                self.y_origin + my * self.resolution)

    def world_to_map(self, wx: float, wy: float) -> tuple[float, float] | None:
        if (
            wx < self.x_origin or wy < self.y_origin
            or wx >= self.x_origin + self.width * self.resolution
            or wy >= self.y_origin + self.height * self.resolution
        ):
            return None
        return ((wx - self.x_origin) / self.resolution,
                (wy - self.y_origin) / self.resolution)

    def _is_cell_obstacle(self, x: int, y: int) -> bool:
        # Out-of-map is "obviously not a goal" / treated obstacle
        # (epic_navigation_node_ompl.cpp:228-247).
        if self.obstacle is None or not (0 <= x < self.width and 0 <= y < self.height):
            return True
        return bool(self.obstacle[y, x])

    def _reset_alg(self) -> None:
        self.planner = None

    # -- subscriber (subOccupancyGrid, :250-287) ----------------------------

    def sub_occupancy_grid(self, grid: msg.OccupancyGrid) -> None:
        data = np.asarray(grid.data).reshape(grid.height, grid.width)
        if (grid.width, grid.height) != (self.width, self.height):
            self.obstacle = np.zeros((grid.height, grid.width), dtype=bool)
            self.goal = None
        self.width, self.height = grid.width, grid.height
        self.resolution = grid.resolution
        self.x_origin, self.y_origin = grid.origin_x, grid.origin_y
        interior = self.obstacle[1:-1, 1:-1]
        d = data[1:-1, 1:-1]
        # Goal cells and NO_CHANGE are untouched (:271-273); there is at most
        # one goal and it is a continuous point — protect its containing cell.
        change = d != C.OCCUPANCY_NO_CHANGE
        if self.goal is not None:
            gx, gy = int(self.goal[0]), int(self.goal[1])
            if 1 <= gx < self.width - 1 and 1 <= gy < self.height - 1:
                change = change.copy()
                change[gy - 1, gx - 1] = False
        interior[change] = d[change] >= C.OCCUPANCY_OBSTACLE_THRESHOLD
        # Boundary ring forced obstacle (setBoundariesAsObstacles, :187-203).
        self.obstacle[0, :] = self.obstacle[-1, :] = True
        self.obstacle[:, 0] = self.obstacle[:, -1] = True
        # Map changes reset the planner (:263).
        self._reset_alg()

    # -- services -----------------------------------------------------------

    def srv_add_goals(self, req: msg.ModifyGoalsRequest) -> msg.ModifyGoalsResponse:
        if self.obstacle is None:
            return msg.ModifyGoalsResponse(success=False)
        # Exactly one goal (:303-307).
        if len(req.goals) != 1:
            return msg.ModifyGoalsResponse(success=False)
        g = req.goals[0]
        m = self.world_to_map(g.x, g.y)
        if m is None:
            return msg.ModifyGoalsResponse(success=False)
        x, y = m
        # Reject goals at obstacles (:314-318; note the reference rounds).
        if self._is_cell_obstacle(int(x + 0.5), int(y + 0.5)):
            return msg.ModifyGoalsResponse(success=False)
        self.goal = (x, y)
        self._reset_alg()
        return msg.ModifyGoalsResponse(success=True)

    def srv_remove_goals(self, req: msg.ModifyGoalsRequest) -> msg.ModifyGoalsResponse:
        if self.obstacle is None or len(req.goals) != 1:
            return msg.ModifyGoalsResponse(success=False)
        g = req.goals[0]
        m = self.world_to_map(g.x, g.y)
        if m is None:
            return msg.ModifyGoalsResponse(success=False)
        # Only unassign if it matches the current goal's cell (:355-361).
        if self.goal is not None and (
            int(m[0] + 0.5), int(m[1] + 0.5)
        ) == (int(self.goal[0] + 0.5), int(self.goal[1] + 0.5)):
            self.goal = None
            self._reset_alg()
        return msg.ModifyGoalsResponse(success=True)

    def srv_set_cells(self, req: msg.SetCellsRequest) -> msg.SetCellsResponse:
        """Cell edits in CELL coords; a GOAL type reassigns the single goal
        (:372-407)."""
        if self.obstacle is None:
            return msg.SetCellsResponse(success=False)
        for i, t in enumerate(req.types):
            x, y = int(req.v[2 * i]), int(req.v[2 * i + 1])
            if not (0 <= x < self.width and 0 <= y < self.height):
                continue
            if t == C.CELL_TYPE_OBSTACLE:
                self.obstacle[y, x] = True
            elif t == C.CELL_TYPE_FREE:
                self.obstacle[y, x] = False
            elif t == C.CELL_TYPE_GOAL:
                self.obstacle[y, x] = False
                self.goal = (float(x), float(y))
        self._reset_alg()
        return msg.SetCellsResponse(success=True)

    def _init_alg(self) -> bool:
        """initAlg (:128-174): requires map + goal + start."""
        if self.planner is not None:
            return True
        if self.obstacle is None or self.goal is None or self.start is None:
            return False
        planner = SamplingPlanner(
            self.algorithm, range_=self._range, seed=self._seed
        )
        try:
            planner.setup(self.obstacle.copy(), self.start, self.goal)
        except ValueError:
            return False
        self.planner = planner
        return True

    def update(self, budget_s: float = 0.05, iterations: int | None = None) -> None:
        """update(t) ≙ ompl_planner->solve(t) (:110-119); warns-and-returns
        when the algorithm is not initialized, like the reference."""
        if self.planner is None:
            return
        self.planner.solve(
            budget_s=None if iterations is not None else budget_s,
            iterations=iterations,
        )

    def srv_compute_path(self, req: msg.ComputePathRequest) -> msg.ComputePathResponse:
        """Assign the start, init the algorithm, and return the best path so
        far (:410-468 — with the TODO at :433-441 completed: the solution
        path is populated when the planner status is 'solved')."""
        m = self.world_to_map(req.start.x, req.start.y)
        if m is not None and m != self.start:
            self.start = m
            self._reset_alg()
        if not self._init_alg():
            # "Algorithm was not initialized" (:427-430) — service fails.
            return msg.ComputePathResponse(
                path=msg.Path(req.start.frame_id, req.start.stamp, [])
            )
        pts = self.planner.solution_path()
        poses: list[msg.PoseStamped] = []
        if pts is not None and len(pts) >= 1:
            # First pose: the request's start verbatim (:449).
            poses.append(req.start)
            for i in range(1, len(pts)):
                x, y = float(pts[i, 0]), float(pts[i, 1])
                yaw = math.atan2(y - float(pts[i - 1, 1]), x - float(pts[i - 1, 0]))
                wx, wy = self.map_to_world(x, y)
                poses.append(msg.PoseStamped(wx, wy, yaw, req.start.frame_id,
                                             req.start.stamp))
        return msg.ComputePathResponse(
            path=msg.Path(req.start.frame_id, req.start.stamp, poses)
        )

    # -- rviz-interaction twins (subMapPoseEstimate/subMapNavGoal,
    #    :471-516) --------------------------------------------------------

    def set_start(self, pose: msg.PoseStamped) -> msg.ComputePathResponse:
        return self.srv_compute_path(
            msg.ComputePathRequest(start=pose, step_size=0.05, precision=0.5)
        )

    def set_goal(self, pose: msg.PoseStamped) -> bool:
        return self.srv_add_goals(msg.ModifyGoalsRequest(goals=[pose])).success
