"""Live run viewer (port of ``lili_om_tpu/utils/live_viz.py``): the
headless counterpart of the reference's live rviz session (every launch file
starts rviz alongside the nodes, LiLi-OM/launch/run_fr_iosb.launch:1-21; the
post-run export is ``utils/viz.py:export_run``).

:class:`LiveViewer` hooks the system's map-publish cadence
(``LiliOmSystem.map_callback``, the publishCompleteMap analog,
BackendFusion.cpp:2687-2696) and on every publish atomically refreshes a
directory of live artifacts:

* ``overview.png`` — the top-down map + trajectory figure (the
  auto-refreshing ``index.html`` wraps it);
* ``trajectory.tum`` — the current per-frame POSITIONS in TUM format
  (identity quaternions: valid for translation metrics and plots);
* ``status.json`` — frame / keyframe / loop counters.

``serve()`` starts a stdlib HTTP server on the directory, so a browser on
the host shows the run live:

    viewer = LiveViewer("/tmp/live", system)
    viewer.serve(8088)   # open http://host:8088/

Writes are tmp + rename (readers never see a torn file) and run on the
thread that publishes the map (the runner's backend thread) while the
frontend appends to ``system.trajectory``: :meth:`update` copies the lists
before reading them and moves tensors to the host. ``figure=False`` drops
the PNG (and the need for matplotlib) and keeps the cheap text artifacts.
"""
from __future__ import annotations

import importlib.util
import json
import os
import threading

import numpy as np

from .evaluation import host

_INDEX_HTML = """<!doctype html><html><head><title>lili_om_tpu_torch live</title>
<style>body{background:#fcfcfb;font-family:sans-serif;margin:1.5em}</style>
</head><body><h3>lili_om_tpu_torch — live run</h3>
<img src="overview.png" id="im" style="max-width:95vw">
<pre id="st"></pre>
<script>
/* JS-only refresh (no meta reload — a full-page reload would kill this
   timer and double-fetch every artifact): swap the image + status with
   cache-busted URLs, flicker-free. */
const bust = () => Date.now();
const tick = () => {
  document.getElementById('im').src = 'overview.png?ts=' + bust();
  fetch('status.json?ts=' + bust()).then(r => r.json())
    .then(s => document.getElementById('st').textContent =
               JSON.stringify(s, null, 1)).catch(() => {});
};
tick();
setInterval(tick, 5000);
</script></body></html>
"""


class LiveViewer:
    """Attachable live visualization for a running :class:`LiliOmSystem`."""

    def __init__(self, out_dir: str, system=None, figure: bool = True):
        """``figure=True`` needs matplotlib and raises here without it."""
        if figure and importlib.util.find_spec("matplotlib") is None:
            raise ImportError("LiveViewer(figure=True) draws overview.png with matplotlib, "
                              "which is not installed; pass figure=False")
        self.out_dir = out_dir
        self.figure = figure
        self.n_updates = 0
        self._httpd = None
        os.makedirs(out_dir, exist_ok=True)
        self._write(os.path.join(out_dir, "index.html"), _INDEX_HTML.encode())
        if system is not None:
            self.attach(system)

    # -- wiring ----------------------------------------------------------
    def attach(self, system) -> None:
        """Hook the system's map-publish cadence: the viewer refreshes every
        ``system.map_publish_period`` seconds of scan time (50 s default,
        like the reference's map thread)."""
        self._system = system
        system.map_callback = lambda map_pts: self.update(system, map_pts)

    def serve(self, port: int = 8088) -> int:
        """Serve ``out_dir`` over HTTP in a daemon thread; returns the bound
        port (0 picks a free one)."""
        import functools
        import http.server
        import socketserver

        class _Quiet(http.server.SimpleHTTPRequestHandler):
            # the index polls every 5 s — without this override the stdlib
            # handler floods the run's console with GET log lines (the
            # override must live on the CLASS; setting it on a partial
            # object would never be looked up)
            def log_message(self, *a, **k):
                pass

        class _Srv(socketserver.TCPServer):
            allow_reuse_address = True  # instance-scoped, not a stdlib mutation

        handler = functools.partial(_Quiet, directory=self.out_dir)
        self._httpd = _Srv(("", port), handler)
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        return self._httpd.server_address[1]

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    # -- refresh ---------------------------------------------------------
    def update(self, system, map_pts=None) -> None:
        """Refresh the live artifacts from the system's current state.
        Called from the map-publish hook; safe to call manually anytime."""
        traj = [host(t) for t in list(system.trajectory)]
        stamps = list(system._frame_stamps)
        est = np.stack(traj) if traj else np.zeros((0, 3))
        nk = len(system.kf_stamps)
        graph_t = host(system.graph.t[:nk]) if nk else np.zeros((0, 3))
        status = {
            "frames": int(system.n_frames),
            "keyframes": nk,
            "loop_factors": int(system.graph.n_loops),
            "updates": self.n_updates + 1,
        }
        self._write(os.path.join(self.out_dir, "status.json"),
                    json.dumps(status).encode())
        # POSITIONS ONLY: the per-frame trajectory archive carries no
        # orientations, so quaternions are written as identity — translation
        # ATE/plots are valid, rotation metrics are not (use
        # utils/viz.py:export_run post-run for full poses). The leading
        # comment makes the file self-describing for TUM tools.
        tum = "# positions only — identity quaternions (live view)\n" + "".join(
            f"{s} {t[0]} {t[1]} {t[2]} 0 0 0 1\n"
            for s, t in zip(stamps, traj))
        self._write(os.path.join(self.out_dir, "trajectory.tum"),
                    tum.encode())
        if self.figure:
            from .viz import save_overview_png

            tmp = os.path.join(self.out_dir, ".overview.tmp.png")
            save_overview_png(tmp, map_pts=map_pts, est_t=est,
                              graph_t=graph_t,
                              title=f"live — {status['frames']} frames, "
                                    f"{nk} kf")
            os.replace(tmp, os.path.join(self.out_dir, "overview.png"))
        self.n_updates += 1

    @staticmethod
    def _write(path: str, data: bytes) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
