"""Live render preview + memory/callback outputs (counterpart of
core_tpu/gui.py).

The reference ships a Qt4 render window with live tile display and cancel
(src/gui/mywindow.cc, renderwidget.cc; QtOutput hangs off
colorOutput_t::putPixel) plus Python callback outputs with zero-copy tile
views for DCC integration (pyOutput_t + YafTileObject_t,
src/bindings/yafrayinterface.i:26-470).  A desktop toolkit makes no sense
on a remote GPU host, so the equivalents here are:

- MemoryOutput: the memoryIO_t analog — accumulates flushes into a
  preallocated float buffer, exposing zero-copy numpy views.
- CallbackOutput: the pyOutput_t analog — forwards every film flush to a
  user callback (whole image or per-region views).
- LiveView: an in-process HTTP preview (stdlib only) serving the latest
  film as PNG with an auto-refreshing page and a /abort endpoint — the
  render-window analog that works over SSH to a GPU host.

All three plug into render_image(..., on_flush=...).
"""
from __future__ import annotations

import threading

import numpy as np


class MemoryOutput:
    """memoryIO_t analog (src/yafraycore/memoryIO.cc): a float [H,W,4]
    buffer updated on every flush; .image is a zero-copy view."""

    def __init__(self, h: int, w: int):
        self.image = np.zeros((h, w, 4), np.float32)
        self.passes = 0

    def __call__(self, img, pass_idx, chunk_idx):
        self.image[...] = img
        self.passes = pass_idx + 1

    def view(self, x0: int, y0: int, x1: int, y1: int) -> np.ndarray:
        """Zero-copy tile view (YafTileObject_t analog)."""
        return self.image[y0:y1, x0:x1]


class CallbackOutput:
    """pyOutput_t analog: calls draw_area(x0, y0, w, h, tile_view) with a
    zero-copy view per flushed region (whole frame here: the renderer
    flushes full-raster chunks, not CPU tiles) and flush(img) at the end."""

    def __init__(self, draw_area=None, flush=None):
        self.draw_area = draw_area
        self.flush_cb = flush
        self._last = None

    def __call__(self, img, pass_idx, chunk_idx):
        self._last = img
        if self.draw_area is not None:
            h, w = img.shape[:2]
            self.draw_area(0, 0, w, h, img)

    def finish(self):
        if self.flush_cb is not None and self._last is not None:
            self.flush_cb(self._last)


class LiveView:
    """HTTP live preview: GET / (auto-refresh page), /frame.png (latest
    film), /abort and /pause — the reference's cooperative scene signals
    Y_SIG_ABORT / Y_SIG_PAUSE (scene.h:124-126), polled between sample
    chunks the way the reference polls between scanlines
    (integrator.cc:69,218,255)."""

    def __init__(self, port: int = 0, gamma: float = 2.2):
        self.gamma = gamma
        self._png = b""
        self._lock = threading.Lock()
        self.aborted = False
        self._resume = threading.Event()
        self._resume.set()
        self._srv = None
        self.port = port

    @property
    def paused(self) -> bool:
        return not self._resume.is_set()

    def pause(self):
        self._resume.clear()

    def resume(self):
        self._resume.set()

    # --- on_flush hook ---
    def __call__(self, img, pass_idx, chunk_idx):
        from core_tpu_torch.io.image import encode_png, to_uint8
        shown = np.power(np.clip(img[..., :3], 0.0, None),
                         1.0 / self.gamma)
        png = encode_png(to_uint8(shown), level=3)
        with self._lock:
            self._png = png
        if self.aborted:
            raise KeyboardInterrupt("render aborted from live view")
        # cooperative pause: block the render loop until resumed (abort
        # still wins so a paused render can be cancelled)
        while not self._resume.wait(timeout=0.25):
            if self.aborted:
                raise KeyboardInterrupt("render aborted from live view")

    def start(self):
        import http.server

        view = self

        class H(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with view._lock:
                        body = view._png
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.startswith("/abort"):
                    view.aborted = True
                    view._resume.set()
                    self.send_response(200)
                    self.end_headers()
                    self.wfile.write(b"aborting")
                elif self.path.startswith("/pause"):
                    if view.paused:
                        view.resume()
                    else:
                        view.pause()
                    self.send_response(200)
                    self.end_headers()
                    self.wfile.write(b"paused" if view.paused else b"resumed")
                else:
                    page = (b"<html><head><meta http-equiv='refresh' "
                            b"content='1'></head><body style='background:"
                            b"#222'><img src='/frame.png'/> "
                            b"<a href='/abort' style='color:#ccc'>abort</a> "
                            b"<a href='/pause' style='color:#ccc'>pause/"
                            b"resume</a></body></html>")
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(page)

        self._srv = http.server.ThreadingHTTPServer(("127.0.0.1", self.port),
                                                    H)
        self.port = self._srv.server_port
        t = threading.Thread(target=self._srv.serve_forever, daemon=True)
        t.start()
        return self.port

    def stop(self):
        if self._srv is not None:
            self._srv.shutdown()
            self._srv = None


def render_with_preview(scene, opts, port: int = 8787, **kw):
    """Render with a live HTTP preview at http://127.0.0.1:<port>/."""
    from core_tpu_torch.render import render_image
    view = LiveView(port=port)
    actual = view.start()
    print(f"live preview: http://127.0.0.1:{actual}/")
    try:
        return render_image(scene, opts, on_flush=view, **kw)
    finally:
        view.stop()
