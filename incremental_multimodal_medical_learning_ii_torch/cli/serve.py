"""HTTP serving endpoint: raw CXR images in, per-class scores out
(counterpart of the JAX package's ``cli/serve.py``).

Wraps :class:`ChexpertClassifier` (device preprocess -> frozen BioViL
ResNet-50 -> optional adapter -> prompt-cosine scores) in a threaded
stdlib HTTP server.  The weight flags are the classify CLI's.

    python -m incremental_multimodal_medical_learning_ii_torch.cli.serve \
        --biovil-checkpoint biovil.pt --cxr-bert-snapshot cxr_bert_dir \
        --fused-layer1 --port 8000

API:
  GET  /healthz   -> {"status": "ok", "platform": "cuda", "device": "...", "classes": [...]}
  POST /classify  -> {"classes": [...], "scores": [[...]], "preds": [[...]]}
      body: raw image bytes (Content-Type image/* or application/octet-stream),
      or JSON {"images_b64": ["<base64 png/jpeg>", ...]} for a batch.

Concurrent requests are micro-batched (--microbatch-ms, default 5 ms):
a worker thread coalesces whatever arrives within the window into ONE
device dispatch and hands each request its slice. --microbatch-ms 0
falls back to a plain serialization lock.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading

MAX_BODY_BYTES = 64 * 2**20  # request bodies beyond this get 413, not buffered


class MicroBatcher:
    """Coalesce concurrent /classify requests into one device dispatch.

    Request threads enqueue their images and block; a single worker thread
    drains the queue — waiting up to ``max_delay_s`` after the first item
    to let concurrent requests pile up, capped at ``max_images`` per
    dispatch — runs ONE ``predict_arrays`` call, and hands each request its
    slice.  One chip serves many clients at batch efficiency instead of
    serializing single-image dispatches.
    """

    def __init__(self, clf, max_delay_s: float = 0.005, max_images: int | None = None):
        import queue as _queue

        self.clf = clf
        self.max_delay_s = max_delay_s
        self.max_images = max_images or clf.batch_size
        self._q: _queue.Queue = _queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self.dispatches = 0  # observability: device calls vs requests served

    def predict(self, images):
        done = threading.Event()
        slot: dict = {}
        self._q.put((images, done, slot))
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["scores"], slot["preds"]

    def _run(self):
        import queue as _queue
        import time as _time

        while True:
            batch = [self._q.get()]  # block for the first request
            deadline = _time.monotonic() + self.max_delay_s
            n = len(batch[0][0])
            while n < self.max_images:
                timeout = deadline - _time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = self._q.get(timeout=timeout)
                except _queue.Empty:
                    break
                batch.append(item)
                n += len(item[0])
            images = [im for imgs, _, _ in batch for im in imgs]
            try:
                scores, preds = self.clf.predict_arrays(images)
                self.dispatches += 1
            except Exception as e:
                for _, done, slot in batch:
                    slot["error"] = e
                    done.set()
                continue
            off = 0
            for imgs, done, slot in batch:
                slot["scores"] = scores[off : off + len(imgs)]
                slot["preds"] = preds[off : off + len(imgs)]
                off += len(imgs)
                done.set()


def _decode_image(data: bytes):
    """bytes -> (H, W) uint8 grayscale, PIL 'L' convention (the extraction
    loader's semantics, data/images.py::load_image_raw_uint8)."""
    import numpy as np
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    if img.mode != "L":
        img = img.convert("L")
    return np.asarray(img)


def make_server(clf, host: str = "127.0.0.1", port: int = 8000,
                microbatch_s: float = 0.0, client_timeout_s: float = 30.0):
    """Build (not start) the HTTP server around a ChexpertClassifier.

    ``microbatch_s > 0`` routes requests through a :class:`MicroBatcher`
    with that coalescing window; otherwise device access is serialized
    with a plain lock.  ``client_timeout_s`` bounds every socket read —
    including the request line/headers — so a stalled client cannot pin a
    handler thread."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    lock = threading.Lock()
    batcher = MicroBatcher(clf, max_delay_s=microbatch_s) if microbatch_s > 0 else None

    def predict(images):
        if batcher is not None:
            return batcher.predict(images)
        with lock:
            return clf.predict_arrays(images)

    classes = list(clf.class_names)
    device = clf.device
    if device.type == "cuda":
        import torch

        device_name = torch.cuda.get_device_name(device)
    else:
        device_name = "cpu"

    class Handler(BaseHTTPRequestHandler):
        # a stalled client (slowloris) must not pin its handler thread —
        # BaseHTTPRequestHandler blocks in rfile.readline on the REQUEST
        # LINE/HEADERS before any do_* method runs, so the bound has to be
        # the class-level socket timeout (applied by StreamRequestHandler
        # .setup()), not a settimeout inside do_POST
        timeout = client_timeout_s

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *log_args):  # quiet by default
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {
                    "status": "ok",
                    "platform": device.type,
                    "device": device_name,
                    "classes": classes,
                })
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/classify":
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._send(400, {"error": "bad Content-Length"})
                return
            if length < 0:
                # rfile.read(-1) would read to EOF, bypassing the size cap
                self._send(400, {"error": "bad Content-Length"})
                return
            if length > MAX_BODY_BYTES:
                # bound per-request memory BEFORE buffering the body — each
                # ThreadingHTTPServer thread reads independently
                self._send(413, {"error": f"body exceeds {MAX_BODY_BYTES} bytes"})
                return
            try:
                body = self.rfile.read(length)
                ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
                if ctype == "application/json":
                    payload = json.loads(body)
                    b64s = payload.get("images_b64")
                    if not isinstance(b64s, list) or not b64s:
                        raise ValueError('JSON body must carry a non-empty "images_b64" list')
                    images = [_decode_image(base64.b64decode(s)) for s in b64s]
                elif body:
                    images = [_decode_image(body)]
                else:
                    raise ValueError("empty request body")
                # validate HERE so an oversized image is a 400 for ITS
                # request only — inside the micro-batch dispatch it would
                # fail the whole coalesced batch and surface as 500 to
                # innocent concurrent requests
                pad_to = clf.plan.pad_to
                for i, im in enumerate(images):
                    h, w = im.shape[0], im.shape[1]
                    if h > pad_to or w > pad_to:
                        raise ValueError(
                            f"image {i} ({h}x{w}) exceeds pad_to={pad_to}"
                        )
                    # extreme aspect ratios explode the resize target (the
                    # smaller edge scales to `size`, so a 1xW strip asks for
                    # a size*W-wide output and a multi-GB resize matrix) —
                    # no CXR is remotely close to 8:1
                    if max(h, w) > 8 * min(h, w):
                        raise ValueError(
                            f"image {i} aspect ratio {h}x{w} exceeds 8:1"
                        )
            except Exception as e:  # malformed input -> client error
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                scores, preds = predict(images)
            except Exception as e:  # classifier/backend error -> server error
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(200, {
                "classes": classes,
                "scores": [[round(float(v), 6) for v in row] for row in scores],
                "preds": [[int(v) for v in row] for row in preds],
            })

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.microbatcher = batcher  # observability: .dispatches vs requests served
    return srv


def main(argv=None) -> None:
    from incremental_multimodal_medical_learning_ii_torch.cli.classify import (
        add_classifier_args,
        build_classifier,
    )

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_classifier_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--microbatch-ms", type=float, default=5.0,
                   help="coalesce concurrent requests into one device "
                   "dispatch, waiting up to this long after the first; "
                   "0 disables micro-batching")
    args = p.parse_args(argv)

    clf = build_classifier(args)

    import numpy as np

    # warm up: the first call builds the kernels and picks the conv algorithms
    clf.predict_arrays([np.zeros((args.size, args.size), np.uint8)])

    server = make_server(clf, args.host, args.port,
                         microbatch_s=args.microbatch_ms / 1e3)
    print(f"serving on http://{args.host}:{server.server_address[1]}  "
          f"(POST /classify, GET /healthz)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
