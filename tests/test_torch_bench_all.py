"""The port's benchmark suite (``incremental_multimodal_medical_learning_ii_torch/bench_all.py``)
against the JAX repo's ``bench_all.py`` on the CPU: ``report`` line for
line, the analytic models (the roofline's FLOPs and bytes exactly, its
caps against an independent sum without the TPU's feed derate; the text
roofline and the parallel model equal under the same overrides), and every
measured section run with ``--device cpu`` at a tiny size, printing the
JAX section's metric names (with the port's renames) and launching no
kernel."""

import ast
import dataclasses
import json
from pathlib import Path

import pytest

import bench_all as jbench_all
from incremental_multimodal_medical_learning_ii_torch import bench_all
from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import BertDims

from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
RENAMES = {"pallas_cosine_6144x10_us": "cuda_cosine_6144x10_us",
           "xla_cosine_6144x10_us": "torch_cosine_6144x10_us"}
# a tiny size of every section (32^2 crops of 40 x 36 images, batch 2,
# BERT at 2 layers x 128, a few hundred training rows)
TINY = dataclasses.replace(
    bench_all.QUICK, img_h=40, img_w=36, size=32, pad_to=64, extract_batch=2, extract_rounds=1,
    extract_batches_per_round=2, encode_k=(2, 1), text_shape=(2, 16), text_k=(2, 1),
    text_long_shape=(2, 32), text_long_k=(2, 1),
    bert_dims=BertDims(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256),
    train_rows=300, train_batch=64, epoch_k=(2, 1), eval_rows=100, cosine_rows=64,
    cosine_k=(4, 2), serve_clients=2, serve_reqs=2, serve_batch=2, stage_batch=2, stage_k=(2, 1),
)
SUFFIXES = ("_per_sec", "_per_chip", "_us", "_ms", "_byte", "_per_batch", "_per_dispatch")

def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()
            if ln.startswith("{")]


def _without_device(line):
    assert "device" in line
    return {k: v for k, v in line.items() if k != "device"}


@pytest.mark.parametrize("quick", [False, True])
def test_report_matches_jax(monkeypatch, capsys, quick):
    monkeypatch.setattr(jbench_all, "_QUICK", quick)
    monkeypatch.setattr(bench_all, "_QUICK", quick)
    monkeypatch.setattr(bench_all, "_DEVICE", "cpu")
    calls = [(("m", None, "ms"), {}), (("m", None, "ms"), {"launches": {"a": 1}}),
             (("r", 3.14159265, "images/sec"), {"baseline": 1.509, "batch": 4}),
             (("r", 2.0, "us"), {"baseline": None}), (("r", 0.0, "us"), {"x": [1, 2]})]
    for args, kw in calls:
        jbench_all.report(*args, **kw)
    ref = _lines(capsys)
    for args, kw in calls:
        bench_all.report(*args, **kw)
    ours = _lines(capsys)
    assert all(line["device"] == "cpu" for line in ours)
    assert [_without_device(line) for line in ours] == ref
    assert ref[0]["value"] is None and "note" in ref[0] and ref[2]["vs_baseline"] == 2.08
    assert all(line.get("quick") is (True if quick else None) for line in ours)


def _independent_caps(batch, peak, bw):
    """Σ over each stage's convs of max(flops/peak, bytes/bw), plus the
    blocks' identity reads at bw, from a flat list of ResNet-50's convs."""
    convs, ids = {}, {}
    convs["stem"] = [(512, 512, 1, 64, 7, 2)]
    h = 128
    for name, (cin, cmid, cout, stride, blocks) in (("layer1", (64, 64, 256, 1, 3)),
                                                   ("layer2", (256, 128, 512, 2, 4)),
                                                   ("layer3", (512, 256, 1024, 2, 6)),
                                                   ("layer4", (1024, 512, 2048, 2, 3))):
        convs[name], ids[name] = [], 0
        for bi in range(blocks):
            s, ci = (stride, cin) if bi == 0 else (1, cout)
            convs[name] += [(h, h, ci, cmid, 1, 1), (h, h, cmid, cmid, 3, s),
                            (h // s, h // s, cmid, cout, 1, 1)]
            if bi == 0:
                convs[name].append((h, h, ci, cout, 1, s))
            h //= s
            ids[name] += h * h * cout * 2 * batch
    out = {}
    for name, cs in convs.items():
        t = ids.get(name, 0) / bw
        for (hh, ww, ci, co, k, s) in cs:
            f = 2 * (hh // s) * (ww // s) * ci * co * k * k * batch
            b = (hh * ww * ci + (hh // s) * (ww // s) * co + k * k * ci * co) * 2 * batch
            t += max(f / peak, b / bw)
        out[name] = t * 1e3
    return out


@pytest.mark.parametrize("batch", [128, 256])
def test_roofline_flops_and_bytes_equal_jax(monkeypatch, capsys, batch):
    """GF and MB per image equal the JAX model's exactly (at 256: stem 0.41,
    layer1 6.98, ..., 8.9 / 105.3 / 92.6 / 76.0 / 48.2 MB); the caps are
    the H100's, with no TPU feed derate."""
    jbench_all.roofline_model(batch=batch)
    ref = _lines(capsys)
    bench_all.roofline_model(batch=batch)
    ours = _lines(capsys)
    assert [line["metric"] for line in ours] == [line["metric"] for line in ref] \
        == bench_all.SECTIONS["roofline"][1]
    for a, b in zip(ours, ref):
        assert (a["gflops_per_img"], a["mb_per_img"]) == (b["gflops_per_img"], b["mb_per_img"])
    assert [line["gflops_per_img"] for line in ours] == [0.41, 6.98, 10.74, 15.3, 8.46]
    assert [line["mb_per_img"] for line in ours] == [8.9, 105.3, 92.6, 76.0, 48.2]
    caps = _independent_caps(batch, 989e12, 3.35e12)
    for line, name in zip(ours, caps):
        assert abs(line["value"] - caps[name]) <= 5e-4 + 1e-9, (name, line["value"], caps[name])
    monkeypatch.setenv("IMML_PEAK_FLOPS", "197e12")
    monkeypatch.setenv("IMML_HBM_BW", "819e9")
    bench_all.roofline_model(batch=batch)
    caps = _independent_caps(batch, 197e12, 819e9)
    for line, name in zip(_lines(capsys), caps):
        assert abs(line["value"] - caps[name]) <= 5e-4 + 1e-9, (name, line["value"], caps[name])


PEAKS = [{"IMML_PEAK_FLOPS": "989e12", "IMML_HBM_BW": "3.35e12", "IMML_ICI_BW": "450e9"},
         {"IMML_PEAK_FLOPS": "197e12", "IMML_HBM_BW": "819e9", "IMML_ICI_BW": "45e9"}]


@pytest.mark.parametrize("env", PEAKS, ids=["h100", "v5e"])
def test_text_roofline_and_parallel_model_equal_jax(monkeypatch, capsys, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for args in ((256, 32), (32, 512), (2, 16)):
        assert jbench_all.text_roofline(*args) == bench_all.text_roofline(*args)
        ref, ours = _lines(capsys)
        assert _without_device(ours) == ref
    for kw in (dict(), dict(batch=8, seq=128, ways=2, microbatches=4)):
        jbench_all.parallel_model(**kw)
        ref = _lines(capsys)
        bench_all.parallel_model(**kw)
        ours = [_without_device(line) for line in _lines(capsys)]
        for line in ref:
            line["hw_flops_per_link_byte"] = line.pop("hw_flops_per_ici_byte")
            line["bound"] = {"ICI": "NVLink"}.get(line["bound"], line["bound"])
        assert ours == ref


def test_defaults_are_the_h100s(capsys):
    """No override: the H100 SXM's 989 TFLOP/s bf16, 3.35 TB/s and NVLink's
    450 GB/s a direction."""
    bench_all.text_roofline(256, 32)
    bench_all.parallel_model()
    text, *rows = _lines(capsys)
    assert text["bound"] == "compute"
    assert text["value"] == pytest.approx(256 / (256 * text["gflops_per_prompt"] * 1e9 / 989e12),
                                          rel=2e-3)
    assert {r["hw_flops_per_link_byte"] for r in rows} == {round(989e12 / 450e9)}


def test_parallel_model_analytics(capsys):
    """tests/test_device_bench.py::test_parallel_model_analytics on the
    port: every axis row a positive intensity, tp > sp > pp bytes, the pp
    bubble 3/11; tp and sp are NVLink-bound at 4 ways, pp compute-bound."""
    bench_all.parallel_model(batch=32, seq=512, ways=4, microbatches=8)
    rows = {line["metric"].split("_")[2]: line for line in _lines(capsys)}
    assert set(rows) == {"tp", "sp", "pp"}
    for d in rows.values():
        assert d["value"] > 0 and d["comm_mb_per_layer"] > 0
        assert d["bound"] in ("compute", "NVLink")
    assert rows["tp"]["comm_mb_per_layer"] > rows["sp"]["comm_mb_per_layer"]
    assert rows["sp"]["comm_mb_per_layer"] > rows["pp"]["comm_mb_per_layer"]
    assert rows["pp"]["bubble_fraction"] == pytest.approx(3 / 11, abs=1e-3)
    assert rows["tp"]["bound"] == rows["sp"]["bound"] == "NVLink"
    assert rows["pp"]["bound"] == "compute"


def _jax_metric_names():
    """Every metric name the JAX suite can print, read from its source: each
    string constant that names a metric, and each f-string of one field
    filled in with every string constant of the function it stands in; the
    port's renames applied."""
    tree = ast.parse((REPO / "bench_all.py").read_text())
    names = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        consts = {n.value for n in ast.walk(fn)
                  if isinstance(n, ast.Constant) and isinstance(n.value, str)}
        names |= consts
        for node in ast.walk(fn):
            if isinstance(node, ast.JoinedStr) \
                    and sum(isinstance(v, ast.FormattedValue) for v in node.values) == 1:
                parts = [v.value if isinstance(v, ast.Constant) else None for v in node.values]
                names |= {"".join(c if part is None else part for part in parts) for c in consts}
    return {RENAMES.get(n, n) for n in names if n.endswith(SUFFIXES) and " " not in n}


@pytest.mark.parametrize("section", list(bench_all.SECTIONS))
def test_section_on_the_cpu_prints_the_jax_metrics(monkeypatch, capsys, section):
    flags, expected = bench_all.SECTIONS[section]
    monkeypatch.setattr(bench_all, "QUICK", TINY)
    monkeypatch.setattr(bench_all, "_QUICK", False)
    monkeypatch.setattr(bench_all, "_DEVICE", None)
    before = bench_all.launch_counts()
    bench_all.main([*flags, "--device", "cpu"])
    lines = _lines(capsys)
    assert [line["metric"] for line in lines] == expected
    assert all(line["device"] == "cpu" for line in lines)
    assert all(line.get("quick") is ("--quick" in flags or None) for line in lines)
    assert bench_all.launch_counts() == before  # the plain versions: no kernel launched
    for line in lines:
        if line["value"] is not None and "launches" in line:
            assert set(line["launches"].values()) == {0}
    # every name is one the JAX suite prints (the independent check of SECTIONS)
    assert set(expected) <= _jax_metric_names(), set(expected) - _jax_metric_names()


def test_measured_sections_need_cuda_without_device():
    """No fallback: without --device a measured section asks for CUDA."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_all.main(["--serve", "--quick"])
