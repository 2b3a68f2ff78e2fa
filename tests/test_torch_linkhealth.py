"""Port cli/linkhealth.py: the probe's line against the JAX CLI's under
canned leg results, the probe strings' imports, real legs on the CPU, the
deadlines (an ``nvcc`` past its deadline dies with its probe) and
``quick_probe``'s contract.  This host has no card and no ``nvcc``: the
card's legs run in ``chip_smoke.py`` (phase 19)."""

import ast
import json
import os
import stat
import subprocess
import sys
import time
from pathlib import Path

import pytest

from incremental_multimodal_medical_learning_ii_tpu.cli import linkhealth as j_lh
from incremental_multimodal_medical_learning_ii_torch.cli import linkhealth as t_lh
from incremental_multimodal_medical_learning_ii_torch.ops import cuda_build

FORBIDDEN = ("jax", "jaxlib", "incremental_multimodal_medical_learning_ii_tpu")
HEALTHY_RTT = {"rtt_ms": 0.05, "upload_mb_per_s": 9123.4567}
# (rtt/upload leg, compile leg, extra argv): each leg a (result, error) pair
CASES = {
    "healthy": ((HEALTHY_RTT, None), ({"compile_s": 1.234}, None), []),
    "rtt 25 ms": (({"rtt_ms": 25.0, "upload_mb_per_s": 812.0}, None),
                  ({"compile_s": 1.5}, None), []),
    "compile 40 s": ((HEALTHY_RTT, None), ({"compile_s": 40.0}, None), []),
    "compile error": ((HEALTHY_RTT, None), (None, "nvcc failed (rc 1): error"), []),
    "probe timeout": ((None, "timeout"), ({"compile_s": 2.0}, None), []),
    "both time out": ((None, "timeout"), (None, "timeout"), []),
    "skip compile": ((HEALTHY_RTT, None), ({"compile_s": 99.0}, None), ["--skip-compile"]),
    "slow sync, skip compile": (({"rtt_ms": 20.5, "upload_mb_per_s": 3.0}, None),
                                (None, "unused"), ["--skip-compile"]),
}


def _line(main, argv, capsys) -> dict:
    main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


@pytest.mark.parametrize("case", list(CASES))
def test_line_matches_jax_cli(monkeypatch, capsys, case):
    """Both CLIs print the same keys, verdict and values (but the backend's
    name) from the same leg results; JAX's main runs no probe here."""
    rtt, comp, argv = CASES[case]
    lines = {}
    for mod, backend in ((j_lh, "tpu"), (t_lh, "cuda")):
        seen = []

        def probe(code, timeout_s, env_extra, mod=mod, backend=backend, seen=seen):
            seen.append(code)
            if code is not mod._RTT_UPLOAD:
                return comp
            result, err = rtt
            return (None if result is None else dict(result, backend=backend)), err

        monkeypatch.setattr(mod, "_run_probe", probe)
        lines[backend] = _line(mod.main, argv, capsys)
        skip = "--skip-compile" in argv
        assert seen == [mod._RTT_UPLOAD] + ([] if skip else [mod._COMPILE])
    ref, got = lines["tpu"], lines["cuda"]
    assert list(got) == list(ref)
    assert (got.pop("backend"), ref.pop("backend")) == (("cuda", "tpu") if rtt[0] else (None, None))
    assert got == ref


def _import_roots(code: str):
    for node in ast.walk(ast.parse(code)):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("probe", ["_RTT_UPLOAD", "_COMPILE"])
def test_probe_strings_import_no_jax(probe):
    roots = set(_import_roots(getattr(t_lh, probe)))
    assert "torch" in roots and not roots & set(FORBIDDEN), roots


def _recorded(monkeypatch) -> list:
    """The legs' unrounded results, as ``main`` / ``quick_probe`` get them
    (a round trip on the CPU may round to 0.0 ms)."""
    legs, run = [], t_lh._run_probe

    def probe(*args):
        legs.append(run(*args))
        return legs[-1]

    monkeypatch.setattr(t_lh, "_run_probe", probe)
    return legs


def test_round_trip_probe_on_the_cpu(monkeypatch, capsys):
    legs = _recorded(monkeypatch)
    line = _line(t_lh.main, ["--platform", "cpu", "--skip-compile", "--samples", "3",
                             "--upload-mb", "1"], capsys)
    ((raw, err),) = legs
    assert err is None and raw["rtt_ms"] > 0 and raw["upload_mb_per_s"] > 0
    assert line["backend"] == "cpu"
    assert line["rtt_ms"] == round(raw["rtt_ms"], 2)
    assert line["upload_mb_per_s"] == round(raw["upload_mb_per_s"], 1) > 0
    assert line["compile_s"] is None and "compile_error" not in line
    assert line["verdict"] in ("ok", "slow-sync")  # a loaded CI host can be slow


def test_deadlines_give_null_legs(capsys):
    t0 = time.perf_counter()
    line = _line(t_lh.main, ["--device", "cpu", "--probe-timeout", "0.01",
                             "--compile-timeout", "0.01"], capsys)
    assert time.perf_counter() - t0 < 5
    assert line == {"backend": None, "rtt_ms": None, "upload_mb_per_s": None, "compile_s": None,
                    "verdict": "degraded-compile", "probe_error": "timeout",
                    "compile_error": "timeout"}


def test_compile_leg_without_nvcc(capsys):
    try:
        found = cuda_build.nvcc_path()
    except RuntimeError:
        found = None
    if found:
        pytest.skip(f"this host has nvcc ({found})")
    line = _line(t_lh.main, ["--platform", "cpu", "--samples", "1", "--upload-mb", "1"], capsys)
    assert line["backend"] == "cpu" and line["compile_s"] is None
    assert "nvcc not found" in line["compile_error"]
    assert line["verdict"] == "degraded-compile"


def _fake_nvcc(tmp_path: Path, monkeypatch, body: str) -> None:
    """An ``nvcc`` first on PATH (``CUDA_HOME`` pointing nowhere)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie waiting for init's reaping does not)."""
    try:
        stat_line = Path(f"/proc/{pid}/stat").read_text()
    except FileNotFoundError:
        return False
    return stat_line.rsplit(")", 1)[1].split()[0] != "Z"


def test_compile_deadline_kills_nvcc(tmp_path, monkeypatch, capsys):
    """An ``nvcc`` that hangs past the compile leg's deadline dies with the
    probe's process group; the CLI returns at the deadline."""
    pid_file = tmp_path / "nvcc.pid"
    _fake_nvcc(tmp_path, monkeypatch, f'echo $$ > "{pid_file}"\nexec sleep 60\n')
    t0 = time.perf_counter()
    line = _line(t_lh.main, ["--platform", "cpu", "--probe-timeout", "0.01",
                             "--compile-timeout", "1"], capsys)
    assert time.perf_counter() - t0 < 10
    assert line["compile_error"] == "timeout" and line["verdict"] == "degraded-compile"
    # the deadline above may pass before the probe's torch import reaches
    # nvcc: give it the time the import takes here, plus margin
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import torch, numpy"], check=True)
    deadline = 2 * (time.perf_counter() - t0) + 3
    t0 = time.perf_counter()
    line = _line(t_lh.main, ["--platform", "cpu", "--probe-timeout", "0.01",
                             "--compile-timeout", f"{deadline:.2f}"], capsys)
    assert time.perf_counter() - t0 < deadline + 5
    assert line["compile_error"] == "timeout"
    pid = int(pid_file.read_text())
    t0 = time.perf_counter()
    while _alive(pid) and time.perf_counter() - t0 < 5:
        time.sleep(0.05)
    assert not _alive(pid), f"nvcc (pid {pid}) outlived its deadline"


def test_compile_leg_builds_fresh_outside_the_build_dir(tmp_path, monkeypatch, capsys):
    """Under ``--platform cpu`` the leg builds with the port's flags and
    loads the library (a stand-in ``nvcc`` compiles a C stub with gcc),
    launching nothing; each run builds a new salt in a temporary directory,
    never in ``_build/``."""
    record = tmp_path / "record"
    record.mkdir()
    _fake_nvcc(tmp_path, monkeypatch, f"""
for a in "$@"; do src="$a"; done
while [ "$1" != "-o" ]; do echo "$1" >> "{record}/flags"; shift; done
cp "$src" "{record}/$(basename "$(dirname "$src")").cu"
printf 'int probe_launch(void *o, void *s) {{ return 0; }}\\n' > "{record}/stub.c"
exec gcc -shared -fPIC -o "$2" "{record}/stub.c"
""")
    build = sorted(cuda_build.BUILD_DIR.iterdir()) if cuda_build.BUILD_DIR.exists() else []
    lines = [_line(t_lh.main, ["--platform", "cpu", "--samples", "1", "--upload-mb", "1"],
                   capsys) for _ in range(2)]
    for line in lines:
        assert "compile_error" not in line, line
        assert line["compile_s"] is not None and line["compile_s"] >= 0
        assert line["verdict"] in ("ok", "slow-sync")
    flags = (record / "flags").read_text().split()
    assert flags == cuda_build.NVCC_FLAGS * 2
    sources = [p.read_text() for p in sorted(record.glob("*.cu"))]
    assert len(sources) == 2 and sources[0] != sources[1]
    assert all("probe_launch" in s for s in sources)
    after = sorted(cuda_build.BUILD_DIR.iterdir()) if cuda_build.BUILD_DIR.exists() else []
    assert after == build


def test_quick_probe_is_embeddable(monkeypatch, capsys):
    legs = _recorded(monkeypatch)
    ok = t_lh.quick_probe(timeout_s=120, samples=3, upload_mb=1, platform="cpu")
    ((raw, _),) = legs
    assert raw["rtt_ms"] > 0 and raw["upload_mb_per_s"] > 0
    assert ok == {"rtt_ms": round(raw["rtt_ms"], 2),
                  "upload_mb_per_s": round(raw["upload_mb_per_s"], 1)}
    assert t_lh.quick_probe(timeout_s=0.01, platform="cpu") == {"probe_error": "timeout"}
    assert capsys.readouterr().out == ""


def test_no_platform_means_the_card(monkeypatch, capsys):
    """Without ``--platform`` the legs ask for CUDA; where it is absent the
    line says so, with null legs: never the CPU's numbers."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    line = _line(t_lh.main, ["--samples", "1", "--upload-mb", "1"], capsys)
    assert (line["backend"], line["rtt_ms"], line["upload_mb_per_s"], line["compile_s"]) == (
        None, None, None, None)
    assert "CUDA is not available" in line["probe_error"]
    assert "CUDA is not available" in line["compile_error"]
    assert line["verdict"] == "degraded-compile"
    assert "CUDA is not available" in t_lh.quick_probe(timeout_s=120, samples=1,
                                                       upload_mb=1)["probe_error"]
