"""Health probe of the card and its toolchain (counterpart of the JAX
package's ``cli/linkhealth.py``).

A bad number from a benchmark run is either the machine's or the code's.
This CLI measures three legs of the machine that no code of the port
controls and prints ONE JSON line, so a run can be attributed in seconds:

* ``rtt_ms``          — one synchronised round trip (median of
                        ``--samples``): a tiny pageable upload, one kernel
                        and one readback of its scalar.  It is the cost of
                        every ``.item()``-style synchronisation.
* ``upload_mb_per_s`` — host-to-card bandwidth (MiB/s, median) of a
                        ``--upload-mb`` uint8 buffer, pageable, as a numpy
                        array goes up through ``torch.from_numpy(a).to``;
                        a fresh random buffer each sample, made outside the
                        timed region, and one element read back.
* ``compile_s``       — wall time of ONE fresh ``nvcc`` build of a tiny
                        CUDA source with a urandom salt baked in, with the
                        port's own compiler and flags (``sm_90a``), loaded
                        with ``ctypes``, launched once and read back.  It is
                        the one compile step the port has: its kernels build
                        at first use (``ops/cuda_build.py``).  The source is
                        built in a temporary directory, never in ``_build/``.
                        A build that succeeds but takes longer than
                        ``--compile-slow-s`` is ``degraded-compile`` too.

Every leg runs in its own ``python -c`` subprocess, in a session of its
own, under its own deadline: on the deadline the whole process group is
killed, so an ``nvcc`` and its ``cicc``/``ptxas`` children never outlive
it.  A leg that times out or fails reports ``null`` and its error;
``verdict`` is ``ok``, ``slow-sync`` (a round trip above 20 ms) or
``degraded-compile``; the exit code is always 0.

The probes run on the card unless ``--platform cpu`` (or ``--device
cpu``) is given.  On a host without CUDA the legs fail and the line says
so: the probe never measures the CPU in the card's place.  Under
``--platform cpu`` the compile leg builds and loads but launches nothing.

    python -m incremental_multimodal_medical_learning_ii_torch.cli.linkhealth
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

# the directory that holds the package: the probe subprocesses import it
_ROOT = str(Path(__file__).resolve().parents[2])

_PRELUDE = """
import os, time, json
from statistics import median
import numpy as np
import torch
from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device

# unset means CUDA, which raises where it is absent: never the CPU in its place
dev = resolve_device(os.environ.get("IMML_LINKHEALTH_PLATFORM") or None)
"""

_RTT_UPLOAD = _PRELUDE + """
samples = int(os.environ["IMML_LH_SAMPLES"])
mb = int(os.environ["IMML_LH_UPLOAD_MB"])

# round trip: a tiny upload, one kernel and a readback of its scalar
float(torch.from_numpy(np.zeros(8, np.float32)).to(dev).sum())  # context, allocator, kernel
rtt = []
for i in range(samples):
    x = np.full(8, float(i), np.float32)
    t0 = time.perf_counter()
    float(torch.from_numpy(x).to(dev).sum())
    rtt.append((time.perf_counter() - t0) * 1e3)

# upload bandwidth: a pageable copy; a 1-element readback ends it without a
# large download
n = mb * 1024 * 1024
torch.from_numpy(np.zeros(n, np.uint8)).to(dev)[:1].float().sum().item()
rng = np.random.default_rng(0)
rates = []
for _ in range(max(3, samples // 2)):
    buf = rng.integers(0, 256, size=n, dtype=np.uint8)
    t0 = time.perf_counter()
    torch.from_numpy(buf).to(dev)[:1].float().sum().item()
    rates.append(mb / (time.perf_counter() - t0))

print(json.dumps({"backend": dev.type,
                  "rtt_ms": median(rtt), "upload_mb_per_s": median(rates)}))
"""

_COMPILE = _PRELUDE + """
import ctypes, subprocess, tempfile
from pathlib import Path
from incremental_multimodal_medical_learning_ii_torch.ops import cuda_build

# a urandom salt baked into the source: no two runs build the same program
salt = int.from_bytes(os.urandom(4), "little")
source = '''
#include <cuda_runtime.h>
__global__ void probe_kernel(float* out) { out[0] = (float)(SALTu % 65521u); }
extern "C" int probe_launch(float* out, void* stream) {
    probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(out);
    return (int)cudaGetLastError();
}
'''.replace("SALT", str(salt))
nvcc = cuda_build.nvcc_path()
out = torch.zeros(1, device=dev) if dev.type == "cuda" else None  # the context, untimed
with tempfile.TemporaryDirectory() as tmp:
    src, lib = Path(tmp, "probe.cu"), Path(tmp, "probe.so")
    src.write_text(source)
    t0 = time.perf_counter()
    res = subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc {res.returncode}): {res.stdout}{res.stderr}")
    launch = ctypes.CDLL(str(lib)).probe_launch
    if out is not None:
        launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        launch.restype = ctypes.c_int
        err = launch(out.data_ptr(), cuda_build.current_stream(out))
        if err:
            raise RuntimeError(f"probe kernel launch failed: CUDA error {err}")
        if out.item() != salt % 65521:
            raise RuntimeError(f"probe kernel wrote {out.item()}, not {salt % 65521}")
    compile_s = time.perf_counter() - t0
print(json.dumps({"compile_s": compile_s, "salt": salt}))
"""


def _run_probe(code: str, timeout_s: float, env_extra: dict):
    """Run one probe subprocess; returns (parsed dict, error string).

    The probe leads a session of its own: on its deadline (or an
    interrupt) the whole process group is killed and reaped, so the
    compile leg's ``nvcc`` and its children die with it."""
    env = dict(os.environ)
    env.update({k: str(v) for k, v in env_extra.items()})
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    with subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, env=env,
                          start_new_session=True) as proc:
        try:
            out, err = proc.communicate(timeout=timeout_s)
        except BaseException as exc:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            if isinstance(exc, subprocess.TimeoutExpired):
                return None, "timeout"
            raise
    if proc.returncode != 0:
        return None, (err or "probe subprocess failed").strip()[-200:]
    try:
        return json.loads(out.strip().splitlines()[-1]), None
    except (ValueError, IndexError):
        return None, f"unparseable probe output: {out[-200:]!r}"


def quick_probe(timeout_s: float = 45.0, samples: int = 3, upload_mb: int = 4,
                platform: str | None = None) -> dict:
    """One bounded rtt/upload probe for embedding in other reports (a
    benchmark attaches it to a failure record, so a bad number carries the
    machine's state beside it).  Returns ``{"rtt_ms", "upload_mb_per_s"}``
    or ``{"probe_error": ...}``; never raises, never prints, never exceeds
    ~timeout_s.  No compile leg: a fresh build is too dear for a side
    channel."""
    env_extra = {"IMML_LH_SAMPLES": samples, "IMML_LH_UPLOAD_MB": upload_mb}
    if platform:
        env_extra["IMML_LINKHEALTH_PLATFORM"] = platform
    base, err = _run_probe(_RTT_UPLOAD, timeout_s, env_extra)
    if base is None:
        return {"probe_error": err}
    return {"rtt_ms": round(base["rtt_ms"], 2),
            "upload_mb_per_s": round(base["upload_mb_per_s"], 1)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--samples", type=int, default=5)
    p.add_argument("--upload-mb", type=int, default=8)
    p.add_argument("--probe-timeout", type=float, default=120.0,
                   help="deadline of the rtt/upload probe subprocess (its torch import and "
                   "CUDA context included)")
    p.add_argument("--compile-timeout", type=float, default=120.0)
    p.add_argument("--compile-slow-s", type=float, default=30.0,
                   help="a fresh nvcc build slower than this is verdict degraded-compile even "
                   "if it finishes")
    p.add_argument("--skip-compile", action="store_true",
                   help="skip the fresh-build probe (it costs a real nvcc run)")
    p.add_argument("--platform", "--device", dest="platform", choices=("cpu", "cuda"),
                   default=None, help="where the probes run: cuda (default) or cpu; nothing "
                   "falls back")
    args = p.parse_args(argv)

    env_extra = {"IMML_LH_SAMPLES": args.samples, "IMML_LH_UPLOAD_MB": args.upload_mb}
    if args.platform:
        env_extra["IMML_LINKHEALTH_PLATFORM"] = args.platform

    base, base_err = _run_probe(_RTT_UPLOAD, args.probe_timeout, env_extra)
    compile_s = compile_err = None
    if not args.skip_compile:
        comp, compile_err = _run_probe(_COMPILE, args.compile_timeout, env_extra)
        if comp is not None:
            compile_s = comp["compile_s"]

    if base is None:
        # not even a round trip: the card (or its runtime) is unreachable
        verdict = "degraded-compile"
    elif compile_err is not None and not args.skip_compile:
        verdict = "degraded-compile"
    elif compile_s is not None and compile_s > args.compile_slow_s:
        verdict = "degraded-compile"
    elif base["rtt_ms"] > 20.0:
        # >20 ms a synchronisation: per-batch readbacks would dominate a run
        verdict = "slow-sync"
    else:
        verdict = "ok"

    line = {
        "backend": None if base is None else base["backend"],
        "rtt_ms": None if base is None else round(base["rtt_ms"], 2),
        "upload_mb_per_s": None if base is None else round(base["upload_mb_per_s"], 1),
        "compile_s": None if compile_s is None else round(compile_s, 2),
        "verdict": verdict,
    }
    if base_err is not None:
        line["probe_error"] = base_err
    if compile_err is not None:
        line["compile_error"] = compile_err
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
