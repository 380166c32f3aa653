"""Service server: drive the full verb set over a real socket."""

import threading

import numpy as np
import pytest

from epic_tpu import maps
from epic_tpu.planner import PlannerConfig
from epic_tpu.services import messages as msg
from epic_tpu.services.navigation_node import EpicNavigationNodeRviz
from epic_tpu.services.server import EpicClient, EpicServiceServer


@pytest.fixture()
def server_client():
    node = EpicNavigationNodeRviz(PlannerConfig(epsilon=1e-2, steps_per_update=25))
    server = EpicServiceServer(node, port=0)  # ephemeral port
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            server.spin_once()

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    client = EpicClient(port=server.port)
    yield server, client
    stop.set()
    t.join(timeout=5)
    client.close()
    server.close()


def _occupancy(img):
    occ = np.zeros(img.shape, dtype=np.int8)
    occ[img == 0] = 100
    return occ.reshape(-1).tolist()


def test_full_replanning_session_over_socket(server_client):
    server, client = server_client
    img = maps.open_room(40, 40)

    r = client.call(
        "occupancy_grid", width=40, height=40, data=_occupancy(img)
    )
    assert r["success"]

    r = client.call("info")
    assert r["initialized"] and r["shape"] == [40, 40]

    assert client.call("add_goals", goals=[[20.0, 20.0]])["success"]
    assert client.call("get_cell", x=20, y=20) == {"success": True, "value": 0.0}

    # Let the anytime loop relax for a bit (server thread is updating).
    import time

    deadline = time.time() + 20
    while time.time() < deadline:
        if client.call("info")["iteration"] >= 500:
            break
        time.sleep(0.1)
    assert client.call("info")["iteration"] >= 500

    r = client.call("compute_path", x=5.0, y=5.0, step_size=0.2, precision=0.4)
    assert r["success"]
    path = np.asarray(r["path"])
    assert len(path) > 2
    assert abs(path[-1][0] - 20) < 2 and abs(path[-1][1] - 20) < 2

    # Pause stops iteration growth.
    assert client.call("set_status", paused=True)["success"]
    it0 = client.call("info")["iteration"]
    time.sleep(0.3)
    assert client.call("info")["iteration"] == it0
    client.call("set_status", paused=False)

    # Cell edits + reset. Pause first: otherwise the anytime loop re-relaxes
    # the freed cell from its neighbours before we can read it (the
    # warm-restart semantic working as intended).
    assert client.call("set_status", paused=True)["success"]
    assert client.call("set_cells", v=[7, 9], types=[1])["success"]
    assert client.call("remove_goals", goals=[[20.0, 20.0]])["success"]
    assert client.call("reset_free_cells")["success"]
    assert client.call("get_cell", x=20, y=20)["value"] == -1e6


def test_malformed_requests_get_clean_errors(server_client):
    _, client = server_client
    r = client.call("nonexistent_srv")
    assert not r["success"] and "unknown srv" in r["error"]
    r = client.call("get_cell", x=3)  # missing y
    assert not r["success"] and "bad request" in r["error"]
    r = client.call("compute_path", x=1.0, y=1.0)  # planner uninitialized
    assert not r["success"]
    # Raw garbage line.
    client.sock.sendall(b"this is not json\n")
    import json

    while b"\n" not in client._buf:
        client._buf += client.sock.recv(1 << 20)
    line, client._buf = client._buf.split(b"\n", 1)
    assert not json.loads(line)["success"]


def test_slow_reader_does_not_crash_server(server_client):
    """Responses larger than the kernel send buffer must be retained and
    flushed on EVENT_WRITE readiness, never crash the loop or corrupt
    framing (non-blocking sockets raise BlockingIOError on full buffers)."""
    import json
    import socket
    import time

    server, client = server_client
    img = maps.open_room(64, 64)
    assert client.call("occupancy_grid", width=64, height=64,
                       data=_occupancy(img))["success"]
    assert client.call("add_goals", goals=[[32.0, 32.0]])["success"]
    deadline = time.time() + 20
    while time.time() < deadline and client.call("info")["iteration"] < 300:
        time.sleep(0.1)

    # A second client that reads nothing while pipelining many large
    # requests; tiny receive window so the server-side send buffer fills.
    slow = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    slow.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    slow.connect(("127.0.0.1", server.port))
    time.sleep(0.2)
    # Shrink the server side's send buffer too (via server internals).
    for sock in list(server._buffers):
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 8192)

    n_req = 30
    req = (json.dumps({"srv": "compute_path", "x": 5.0, "y": 5.0,
                       "step_size": 0.05, "precision": 0.5}) + "\n").encode()
    slow.sendall(req * n_req)

    # Give the server time to dispatch everything while we read nothing;
    # a sendall()-based server would crash its loop here.
    time.sleep(1.0)
    assert client.call("info")["success"]  # loop is still alive

    # Now drain; every response must arrive, one intact JSON per line.
    slow.settimeout(30)
    buf = b""
    lines = []
    while len(lines) < n_req:
        data = slow.recv(1 << 16)
        assert data, "server closed before delivering all responses"
        buf += data
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            lines.append(line)
    for line in lines[:n_req]:
        r = json.loads(line)
        assert r["success"] and len(r["path"]) > 2
    slow.close()


def test_partial_line_framing(server_client):
    """Requests split across packets and multiple requests per packet must
    both frame correctly."""
    import json
    import socket
    import time

    server, _ = server_client
    raw = socket.create_connection(("127.0.0.1", server.port), timeout=10)
    payload = json.dumps({"srv": "info"}).encode() + b"\n"
    # Drip one request byte by byte.
    for i in range(0, len(payload), 3):
        raw.sendall(payload[i : i + 3])
        time.sleep(0.01)
    # Then two requests in a single packet.
    raw.sendall(payload + payload)
    buf = b""
    while buf.count(b"\n") < 3:
        data = raw.recv(1 << 16)
        assert data
        buf += data
    for line in buf.split(b"\n")[:3]:
        assert json.loads(line)["success"]
    raw.close()


def test_multi_client_interleaving(server_client):
    server, client1 = server_client
    img = maps.open_room(32, 32)
    assert client1.call("occupancy_grid", width=32, height=32,
                        data=_occupancy(img))["success"]
    client2 = EpicClient(port=server.port)
    client3 = EpicClient(port=server.port)
    try:
        for _ in range(10):
            assert client2.call("info")["success"]
            assert client1.call("get_cell", x=5, y=5)["success"]
            assert client3.call("info")["shape"] == [32, 32]
    finally:
        client2.close()
        client3.close()


def test_get_field_and_get_map_windows(server_client):
    server, client = server_client
    img = maps.open_room(24, 24)
    assert client.call("occupancy_grid", width=24, height=24,
                       data=_occupancy(img))["success"]
    assert client.call("add_goals", goals=[[12.0, 12.0]])["success"]
    r = client.call("get_field", x0=10, y0=11, x1=14, y1=13)
    assert r["success"] and r["width"] == 4 and r["height"] == 2
    u = np.asarray(r["u"])
    assert u.shape == (2, 4)
    assert u[1, 2] == 0.0  # the goal cell (12, 12)
    m = client.call("get_map")
    assert m["success"] and m["width"] == 24 and m["height"] == 24
    cells = np.asarray(m["cells"])
    assert cells[12, 12] == 255 and cells[0, 0] == 0 and cells[5, 5] == 128
    # Clamping
    r = client.call("get_field", x0=-5, y0=20, x1=999, y1=999)
    assert r["success"] and r["x0"] == 0 and r["height"] == 4


def test_compute_paths_batch_verb(server_client):
    import time

    server, client = server_client
    img = maps.open_room(40, 40)
    assert client.call("occupancy_grid", width=40, height=40,
                       data=_occupancy(img))["success"]
    assert client.call("add_goals", goals=[[20.0, 20.0]])["success"]
    deadline = time.time() + 20
    while time.time() < deadline and client.call("info")["iteration"] < 300:
        time.sleep(0.1)
    r = client.call("compute_paths",
                    starts=[[5.0, 5.0], [-9.0, 1.0], [30.0, 30.0]],
                    step_size=0.2, precision=0.4)
    assert r["success"]
    assert r["paths"][1] is None
    for idx in (0, 2):
        p = np.asarray(r["paths"][idx])
        assert len(p) > 2
        assert abs(p[-1][0] - 20) < 2.5 and abs(p[-1][1] - 20) < 2.5


def test_volume_session_3d_verbs(server_client):
    """The *_3d verb family drives an independent 3D session that relaxes
    in the same anytime loop as the 2D planner."""
    server, client = server_client

    # No 3D session yet.
    r = client.call("get_cell_3d", x=1, y=1, z=1)
    assert not r["success"]

    d, h, w = 12, 16, 20
    vol = np.full((d, h, w), 0, dtype=np.int8)  # all free (occupancy 0)
    r = client.call("occupancy_volume", depth=d, height=h, width=w,
                    data=vol.reshape(-1).tolist(), resolution=1.0,
                    origin=[0.0, 0.0, 0.0])
    assert r["success"]

    assert client.call("add_goals_3d", goals=[[10.0, 8.0, 6.0]])["success"]
    assert client.call("get_cell_3d", x=10, y=8, z=6) == {
        "success": True, "value": 0.0}

    # Duplicate voxel resolves last-wins through set_cells_3d
    # (obstacle then goal -> goal).
    assert client.call("set_cells_3d", v=[3, 3, 3, 3, 3, 3],
                       types=[1, 0])["success"]
    assert client.call("get_cell_3d", x=3, y=3, z=3)["value"] == 0.0

    import time

    deadline = time.time() + 20
    while time.time() < deadline:
        info = client.call("info")
        if info.get("volume", {}).get("iteration", 0) >= 200:
            break
        time.sleep(0.1)
    assert info["volume"]["shape"] == [d, h, w]
    assert info["volume"]["iteration"] >= 200

    r = client.call("compute_path_3d", x=3.0, y=12.0, z=9.0,
                    step_size=0.2, precision=0.4)
    assert r["success"]
    end = r["path"][-1]
    assert abs(end[0] - 10) < 2 and abs(end[1] - 8) < 2 and abs(end[2] - 6) < 2
    assert len(r["path"][0]) == 5  # x, y, z, yaw, pitch

    # Pause only the 3D session; the 2D planner is untouched.
    assert client.call("set_status_3d", paused=True)["success"]
    it0 = client.call("info")["volume"]["iteration"]
    time.sleep(0.3)
    assert client.call("info")["volume"]["iteration"] == it0

    # While paused (no background relaxation racing the assertions):
    # removing the goal frees the voxel, reset clears stale potentials.
    assert client.call("remove_goals_3d", goals=[[10.0, 8.0, 6.0]])["success"]
    assert client.call("reset_free_cells_3d")["success"]
    assert client.call("get_cell_3d", x=10, y=8, z=6)["value"] == pytest.approx(
        -1e6)
    assert client.call("set_status_3d", paused=False)["success"]


def test_metrics_verb_reports_latency_and_errors(server_client):
    server, client = server_client
    img = maps.open_room(24, 24)
    assert client.call("occupancy_grid", width=24, height=24, resolution=1.0,
                       origin_x=0.0, origin_y=0.0, data=_occupancy(img))["success"]
    assert client.call("get_cell", x=3, y=3)["success"]
    assert not client.call("nonsense_verb")["success"]

    m = client.call("metrics")
    assert m["success"]
    assert m["counters"]["verb.occupancy_grid.calls"] == 1
    assert m["counters"]["verb.get_cell.calls"] == 1
    assert m["counters"]["verb.nonsense_verb.errors"] == 1
    lat = m["latencies"]["verb.get_cell"]
    assert lat["count"] == 1 and lat["max_s"] >= lat["min_s"] >= 0.0
    assert m["uptime_s"] > 0.0
    # the background spin loop has been ticking the whole session
    assert m["counters"]["ticks"] >= 1
    assert m["latencies"]["tick.update"]["count"] >= 1


def test_metrics_registry_unit():
    from epic_tpu.metrics import MetricsRegistry

    r = MetricsRegistry()
    r.inc("a")
    r.inc("a", 2)
    with r.timed("op"):
        pass
    with r.timed("op"):
        pass
    snap = r.snapshot()
    assert snap["counters"]["a"] == 3
    assert snap["latencies"]["op"]["count"] == 2
    assert snap["latencies"]["op"]["mean_s"] >= 0.0


def test_json_log_formatter():
    import json as _json
    import logging

    from epic_tpu.metrics import JsonLogFormatter, configure_logging

    rec = logging.LogRecord("epic_tpu.server", logging.INFO, __file__, 1,
                            "client connected: %s", ("addr",), None)
    line = JsonLogFormatter().format(rec)
    obj = _json.loads(line)
    assert obj["msg"] == "client connected: addr"
    assert obj["level"] == "INFO"

    configure_logging(json_lines=True)
    configure_logging(json_lines=False)  # idempotent swap, no handler pileup
    root = logging.getLogger("epic_tpu")
    installed = [h for h in root.handlers
                 if getattr(h, "_epic_tpu_installed", False)]
    assert len(installed) == 1
    root.removeHandler(installed[0])


def test_sampling_verb_family(server_client):
    """The sampling_* family (the reference's unbuilt OMPL node as a
    service session): ingest -> goal -> start -> anytime budget per tick ->
    populated path."""
    import time

    server, client = server_client
    n = 32
    data = np.zeros((n, n), dtype=np.int8)
    data[:, 16] = 100
    data[14:18, 16] = 0

    # Verbs before ingest fail cleanly.
    r = client.call("sampling_compute_path", start=[3.0, 3.0])
    assert not r["success"] and "sampling" in r["error"]

    assert client.call(
        "sampling_occupancy", width=n, height=n, seed=3,
        data=data.reshape(-1).tolist(),
    )["success"]
    assert client.call("sampling_add_goals", goals=[[27.0, 27.0]])["success"]
    # Goal at an obstacle rejected.
    assert not client.call("sampling_add_goals", goals=[[16.0, 2.0]])["success"]

    # First compute_path assigns the start; the spin loop then grows the
    # search with its per-tick budget until solved.
    r = client.call("sampling_compute_path", start=[3.0, 3.0])
    assert r["success"]
    deadline = time.time() + 30
    while time.time() < deadline:
        r = client.call("sampling_compute_path", start=[3.0, 3.0])
        if r["solved"] and len(r["path"]) >= 2:
            break
        time.sleep(0.1)
    assert r["solved"] and len(r["path"]) >= 2
    assert np.hypot(r["path"][-1][0] - 27.0, r["path"][-1][1] - 27.0) < 1e-6

    info = client.call("info")
    assert info["sampling"]["solved"] and info["sampling"]["iterations"] > 0

    # set_cells with a GOAL reassigns the single goal.
    assert client.call("sampling_set_cells", v=[26, 8], types=[0])["success"]
    r = client.call("sampling_compute_path", start=[3.0, 3.0])
    assert r["success"] and not r["solved"]  # planner reset by the edit


def test_cli_main_subprocess(tmp_path):
    """`python -m epic_tpu.services.server` end-to-end: real process, map
    preload from a PNG, client session over TCP, clean kill."""
    import json
    import os
    import socket
    import subprocess
    import sys
    import time

    from epic_tpu import maps, viz

    img = maps.recursive_maze(48, 48, seed=9)
    png = tmp_path / "m.png"
    viz.save_png(str(png), np.stack([img] * 3, axis=-1))

    # Pick a free port (the CLI has no port-0 mode printing back the choice
    # we could parse robustly under buffering, so bind/release one).
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "epic_tpu.services.server",
         "--port", str(port), "--backend", "xla", "--map", str(png),
         "--epsilon", "1e-2", "--steps-per-update", "25"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
    )
    try:
        cli = None
        # A fresh process imports JAX and compiles before it listens; that
        # is slow when the suite runs other modules concurrently.
        deadline = time.time() + 300
        while time.time() < deadline:
            try:
                cli = EpicClient(port=port, timeout=60.0)
                break
            except OSError:
                assert proc.poll() is None, "server process died"
                time.sleep(0.3)
        assert cli is not None, "server never accepted connections"

        info = cli.call("info")
        assert info.get("initialized") and info["shape"] == [48, 48]
        # The map's goal pixels were seeded as goals; wait for a usable field.
        ys, xs = np.nonzero(img == 254) if (img == 254).any() else np.nonzero(img > 0)
        i = len(ys) // 3
        deadline = time.time() + 120
        got = False
        while time.time() < deadline:
            r = cli.call("compute_path", x=float(xs[i]), y=float(ys[i]),
                         step_size=0.2, precision=0.4)
            if r.get("path"):
                got = True
                break
            time.sleep(0.2)
        assert got, f"no path over CLI server: {json.dumps(r)[:200]}"
        cli.close()
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_compute_paths_3d_batch_verb(server_client):
    """Batched multi-start 3D extraction over the socket (device walker)."""
    import time

    server, client = server_client
    d, h, w = 12, 16, 20
    vol = np.full((d, h, w), 0, dtype=np.int8)
    assert client.call("occupancy_volume", depth=d, height=h, width=w,
                       data=vol.reshape(-1).tolist(), resolution=1.0,
                       origin=[0.0, 0.0, 0.0])["success"]
    assert client.call("add_goals_3d", goals=[[10.0, 8.0, 6.0]])["success"]
    deadline = time.time() + 20
    while time.time() < deadline:
        if client.call("info").get("volume", {}).get("iteration", 0) >= 200:
            break
        time.sleep(0.1)

    r = client.call("compute_paths_3d",
                    starts=[[3.0, 12.0, 9.0], [16.0, 3.0, 2.0],
                            [-99.0, 0.0, 0.0]],
                    step_size=0.2, precision=0.4)
    assert r["success"]
    paths = r["paths"]
    assert len(paths) == 3
    assert paths[2] is None  # off-volume start: per-lane invalid contract
    for p in paths[:2]:
        assert p is not None and len(p) > 2
        end = p[-1]
        assert abs(end[0] - 10) < 2 and abs(end[1] - 8) < 2 and abs(end[2] - 6) < 2
