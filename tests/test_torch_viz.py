"""utils/viz, utils/live_viz and utils/metrics.device_trace against the JAX
package: PLY bytes, the overview PNG, ``export_run`` and the live viewer's
artifacts of a port run and of the same run loaded into the JAX system
(the TUM, PLY and PCD files and the live text artifacts byte for byte: the
same keyframe clouds and graph poses through the same host downsample),
the viewer's HTTP serving (tests/test_viz.py:57-80), and a profiler trace
written on the CPU."""
import importlib.util
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from lili_om_tpu.io import checkpoint as JCK
from lili_om_tpu.utils import live_viz as JLV
from lili_om_tpu.utils import viz as JV
from lili_om_tpu_torch.io import checkpoint as TCK
from lili_om_tpu_torch.utils import live_viz as TLV
from lili_om_tpu_torch.utils import viz as TV
from lili_om_tpu_torch.utils.metrics import device_trace
from test_torch_common import jax_tiny_system, tiny_run

HAS_MPL = importlib.util.find_spec("matplotlib") is not None
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("colors", [False, True])
def test_write_ply_bytes_match_jax(tmp_path, colors):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(257, 3)) * 20
    cols = rng.integers(0, 256, (257, 3)).astype(np.uint8) if colors else None
    pj, pt = tmp_path / "j.ply", tmp_path / "t.ply"
    assert JV.write_ply(str(pj), pts, cols) == 257
    assert TV.write_ply(str(pt), torch.as_tensor(pts),
                        None if cols is None else torch.as_tensor(cols)) == 257
    assert pt.read_bytes() == pj.read_bytes()


def test_overview_png(tmp_path):
    """A rendered figure (the JAX test's size floor) from tensors and
    arrays; without matplotlib, an ImportError naming the file."""
    rng = np.random.default_rng(0)
    p = str(tmp_path / "overview.png")
    args = dict(map_pts=torch.as_tensor(rng.normal(size=(500, 3)) * 10),
                est_t=np.cumsum(rng.normal(size=(50, 3)), axis=0),
                graph_t=torch.as_tensor(np.cumsum(rng.normal(size=(20, 3)), axis=0)),
                gt_t=np.cumsum(rng.normal(size=(50, 3)), axis=0))
    if HAS_MPL:
        TV.save_overview_png(p, **args)
        assert open(p, "rb").read(8) == PNG_MAGIC and os.path.getsize(p) > 10_000
    else:
        with pytest.raises(ImportError, match="overview.png"):
            TV.save_overview_png(p, **args)


@pytest.fixture(scope="module")
def run_pair(tmp_path_factory):
    """A port run of ``tiny_system`` (8 scans) and the JAX system loaded from
    its checkpoint."""
    d = tmp_path_factory.mktemp("viz")
    t = tiny_run(8)
    TCK.save_system(str(d / "ck"), t)
    j = jax_tiny_system()
    JCK.load_system(str(d / "ck"), j)
    return t, j


def test_export_run_matches_jax(tmp_path, run_pair):
    t, j = run_pair
    est = np.stack(t.trajectory)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    if not HAS_MPL:
        with pytest.raises(ImportError, match="overview.png"):
            TV.export_run(dt, t, est_t=est)
        return
    pj = JV.export_run(dj, j, est_t=est)
    pt = TV.export_run(dt, t, est_t=torch.as_tensor(est))
    assert {k: os.path.basename(v) for k, v in pt.items()} == \
        {k: os.path.basename(v) for k, v in pj.items()}
    for key in ("trajectory_tum", "map_pcd", "map_ply"):
        assert open(pt[key], "rb").read() == open(pj[key], "rb").read(), key
    n = len(t.build_global_map())
    assert n > 100 and f"element vertex {n}".encode() in open(pt["map_ply"], "rb").read(200)
    assert open(pt["overview_png"], "rb").read(8) == PNG_MAGIC


def test_live_viewer_artifacts_match_jax(tmp_path, run_pair):
    """The map-publish hook wires the viewer; an update writes the same
    status and position TUM text as the JAX viewer's on the same run."""
    t, j = run_pair
    map_pts = t.build_global_map()
    dirs = {}
    for name, mod, s in (("jax", JLV, j), ("port", TLV, t)):
        dirs[name] = tmp_path / name
        v = mod.LiveViewer(str(dirs[name]), s, figure=HAS_MPL)
        assert s.map_callback is not None
        s.map_callback(map_pts)
        assert v.n_updates == 1
    names = ["status.json", "trajectory.tum", "index.html"] + (["overview.png"] if HAS_MPL
                                                                else [])
    for name in names:
        assert (dirs["port"] / name).exists(), name
    for name in ("status.json", "trajectory.tum"):
        assert (dirs["port"] / name).read_bytes() == (dirs["jax"] / name).read_bytes(), name
    st = json.loads((dirs["port"] / "status.json").read_text())
    assert st == {"frames": 8, "keyframes": len(t.kf_stamps), "loop_factors": 0, "updates": 1}
    assert not list(dirs["port"].glob("*.tmp*"))  # every write renamed into place


def test_live_viewer_serves_http(tmp_path, run_pair):
    t, _ = run_pair
    v = TLV.LiveViewer(str(tmp_path), t, figure=False)
    v.update(t)
    port = v.serve(0)
    try:
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/status.json", timeout=5).read()
        assert b"keyframes" in body
        idx = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5).read()
        assert b"lili_om_tpu_torch" in idx
    finally:
        v.close()


def test_device_trace_writes_a_trace(tmp_path):
    """On the CPU the trace holds the window's host operations."""
    with device_trace(str(tmp_path / "tr")) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum()
    events = json.load(open(prof.trace_path))["traceEvents"]
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "tr")
    assert any(e.get("name") == "aten::matmul" for e in events)
