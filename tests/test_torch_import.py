"""The PyTorch port stands alone: it imports no JAX, nothing of the JAX
package (not even its native runtime's library) and none of the packages
the card's machine lacks (transformers, safetensors, matplotlib, sklearn,
tensorboard, optax), and its entry points do not quietly run on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_port_helpers import trace_spans

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "incremental_multimodal_medical_learning_ii_torch"
FORBIDDEN = ("jax", "jaxlib", "incremental_multimodal_medical_learning_ii_tpu",
             "transformers", "safetensors", "matplotlib", "sklearn", "tensorboard", "optax")
# the training slice's modules, which must be among those imported
TRAINING_MODULES = ("engine.steps", "engine.trainer", "engine.protocols", "engine.cl",
                    "engine.checkpoint", "evaluation.metrics", "evaluation.tb",
                    "objectives.losses", "data.store", "cli.zero_joint_bounds",
                    "cli.data_incremental", "cli.class_incremental")
# the extraction slice's modules, and the paper's table over the drivers
EXTRACTION_MODULES = ("engine.extract", "ops.quant", "ops.preprocess", "data.images",
                      "data.manifest", "utils.serialization", "cli.extract_embeddings",
                      "cli.verify_embeddings", "cli.convert_weights", "cli.prepare_data",
                      "cli.reproduce")
# the grounding slice's modules: the VLP engines and their CLIs, the rest of
# the image model surface and the native store
GROUNDING_MODULES = ("vlp", "vlp.engine", "models.image_engine", "models.heads", "runtime",
                     "data.native", "cli.ground", "cli.dataset_stats")
# the data-parallel slice: ranks over torch.distributed
MESH_MODULES = ("parallel", "parallel.mesh")
# the sweeps, and the text tower's tensor-, sequence- and pipeline-parallel
# encodes with the dry run over ranks
SWEEP_TEXT_PARALLEL_MODULES = ("engine.sweep", "cli.sweep", "ops.ring_attention", "parallel.tp",
                               "parallel.sp", "parallel.pp", "multichip")
# the figures: PIL drawing, the sklearn curve points, PCA and t-SNE in torch
FIGURE_MODULES = ("evaluation.plots", "evaluation.projection", "cli.analyze_prompts")
# the health probe of the card and its toolchain
PROBE_MODULES = ("cli.linkhealth",)

_IMPORT_ALL = """
import importlib, pkgutil, sys
before = set(sys.modules)
import incremental_multimodal_medical_learning_ii_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
new = sorted(set(sys.modules) - before)
print(len(names))
print("\\n".join(new))
"""


def test_import_all_submodules_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    n_modules, loaded = int(lines[0]), lines[1:]
    assert n_modules >= 32
    port = "incremental_multimodal_medical_learning_ii_torch."
    assert all(port + m in loaded
               for m in TRAINING_MODULES + EXTRACTION_MODULES + GROUNDING_MODULES + MESH_MODULES
               + SWEEP_TEXT_PARALLEL_MODULES + FIGURE_MODULES + PROBE_MODULES)
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("subpackage", ["vlp", "runtime", "parallel"])
def test_new_subpackage_imports_alone_without_jax(subpackage):
    """Each subpackage imports on its own in a fresh interpreter, loading no
    JAX and nothing of the JAX package, and building nothing."""
    code = (f"import sys\n"
            f"import incremental_multimodal_medical_learning_ii_torch.{subpackage} as m\n"
            f"import pkgutil, importlib\n"
            f"for i in pkgutil.walk_packages(m.__path__, m.__name__ + '.'):\n"
            f"    importlib.import_module(i.name)\n"
            f"print(sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_library_builds_into_the_ports_build_dir_only():
    """The port loads its own library from its ``_build/``, never the JAX
    package's ``runtime/libembstore.so``, and builds nothing at import."""
    code = (
        "import sys\n"
        "import incremental_multimodal_medical_learning_ii_torch.data.native as n\n"
        "from incremental_multimodal_medical_learning_ii_torch import runtime\n"
        "assert runtime._lib is None\n"
        "if not n.native_available():\n"
        "    print('no toolchain:', runtime.native_build_error()); sys.exit(0)\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(runtime.library_path())\n"
        "print(int('ii_tpu/runtime' in maps), int(str(runtime.library_path()) in maps))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'incremental_multimodal_medical_learning_ii_tpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    if out.stdout.startswith("no toolchain"):
        pytest.skip(out.stdout.strip())
    path, flags, modules = out.stdout.splitlines()
    assert Path(path).parent == REPO / "incremental_multimodal_medical_learning_ii_torch" / "_build"
    assert Path(path).name.startswith("libembstore-")
    assert flags == "0 1" and modules == "[]"


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("target", ["package", "chip_smoke"])
def test_no_jax_import_in_source(target):
    files = (sorted(PORT.rglob("*.py")) if target == "package"
             else [REPO / "chip_smoke.py", REPO / "k2_breakdown.py", REPO / "k3_breakdown.py"])
    assert files and all(f.exists() for f in files)
    for f in files:
        bad = [r for r in _imported_roots(f) if r in FORBIDDEN]
        assert not bad, (f, bad)


def test_entry_points_refuse_without_cuda(monkeypatch):
    """Called without ``device=``, the entry points ask for CUDA and raise
    when it is absent; they never carry on on the CPU."""
    from incremental_multimodal_medical_learning_ii_torch.cli.classify import (
        add_classifier_args,
        build_classifier,
    )
    from incremental_multimodal_medical_learning_ii_torch.inference import ChexpertClassifier
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        init_biovil_image_model,
    )
    from incremental_multimodal_medical_learning_ii_torch.objectives.scorer import PromptBank
    from incremental_multimodal_medical_learning_ii_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    bank = PromptBank(torch.zeros(5, 1, 128), torch.zeros(5, 1, 128),
                      torch.ones(5, dtype=torch.int32), torch.ones(5, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ChexpertClassifier(init_biovil_image_model(), bank)
    import argparse

    p = argparse.ArgumentParser()
    add_classifier_args(p)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_classifier(p.parse_args(["--random-weights"]))
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("entry", ["extract_embeddings", "cli.extract_embeddings",
                                   "cli.reproduce"])
def test_extraction_entry_points_refuse_without_cuda(monkeypatch, tmp_path, entry):
    """Extraction and the paper's table ask for CUDA unless given the CPU."""
    from incremental_multimodal_medical_learning_ii_torch.cli import extract_embeddings as cli
    from incremental_multimodal_medical_learning_ii_torch.cli import reproduce
    from incremental_multimodal_medical_learning_ii_torch.engine.extract import (
        extract_embeddings,
    )
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        init_biovil_image_model,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "extract_embeddings":
            extract_embeddings(iter([]), init_biovil_image_model())
        elif entry == "cli.extract_embeddings":
            cli.main(["--synthetic", "2", "--out-dir", str(tmp_path)])
        else:
            reproduce.main(["--dry-run", "--log-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("driver", ["zero_joint_bounds", "data_incremental", "class_incremental"])
def test_drivers_refuse_without_cuda_and_refuse_what_is_not_ported(monkeypatch, tmp_path, driver):
    """The drivers ask for CUDA unless ``--device cpu``, for their ranks too
    (``--mesh-devices 2`` starts none on the CPU when CUDA is absent).
    Nothing of theirs is left unported: ``--plot-figures final`` writes the
    figures into the event file, ``--tsne-plots`` hands the train set's
    t-SNE subsets to the protocol, and ``--trace-dir`` writes a trace of
    the run."""
    import importlib

    from incremental_multimodal_medical_learning_ii_torch.evaluation.tb import read_images

    cli = importlib.import_module(f"incremental_multimodal_medical_learning_ii_torch.cli.{driver}")
    main = cli.main
    base = ["--synthetic", "--epochs", "1", "--log-dir", str(tmp_path)]
    main([*base, "--plot-figures", "final", "--trace-dir", str(tmp_path / "trace"),
          "--device", "cpu", "--log-dir", str(tmp_path / "f")])
    assert trace_spans(tmp_path / "trace")["eval-pass"] >= 2
    (events,) = (tmp_path / "f").rglob("events.out.tfevents.*")
    tags = {tag for tag, _, _ in read_images(events)}
    assert "test ROC Curve/Curve for Class 0" in tags
    assert "visual-embeddings/t-SNE text-embs" in tags
    bundles = []
    runner = "run_zero_joint" if driver == "zero_joint_bounds" else f"run_{driver}"
    monkeypatch.setattr(cli, runner, lambda cfg, data, *a, **k: bundles.append(data) or {})
    main([*base, "--tsne-plots", "--device", "cpu"])
    ((multiclass, sani_malati),) = [b.tsne_datasets for b in bundles]
    assert len(multiclass) > 0 and len(sani_malati) > 0
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flags in ([], ["--mesh-devices", "2"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([*base, *flags])
    from incremental_multimodal_medical_learning_ii_torch.engine.trainer import Trainer
    from incremental_multimodal_medical_learning_ii_torch.objectives.scorer import PromptBank
    from incremental_multimodal_medical_learning_ii_torch.utils.config import ExperimentConfig

    bank = PromptBank(torch.zeros(5, 1, 128), torch.zeros(5, 1, 128),
                      torch.ones(5, dtype=torch.int32), torch.ones(5, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(ExperimentConfig(), bank)
    assert ExperimentConfig().plot_figures == "reference"  # the JAX package's default
    assert Trainer(ExperimentConfig(plot_figures="reference"), bank, device="cpu").cfg.plot_figures


def test_grounding_engines_refuse_without_cuda(monkeypatch):
    from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
        init_biovil_image_model,
    )
    from incremental_multimodal_medical_learning_ii_torch.models.image_engine import (
        ImageInferenceEngine,
    )
    from incremental_multimodal_medical_learning_ii_torch.vlp.engine import (
        ImageTextInferenceEngine,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = init_biovil_image_model()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ImageInferenceEngine(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ImageTextInferenceEngine(model, text_engine=None)
    assert ImageTextInferenceEngine(model, None, device="cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_foreign_devices():
    """A wrapper takes its plain version only for CPU tensors; anything
    else that is not CUDA is an error, not a fallback."""
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_bottleneck import (
        fused_bottleneck_layer,
    )
    from incremental_multimodal_medical_learning_ii_torch.ops.fused_cosine import (
        fused_pairwise_cosine,
    )

    x = torch.zeros(4, 128, device="meta")
    with pytest.raises(ValueError, match="meta"):
        fused_pairwise_cosine(x, x)
    with pytest.raises(ValueError, match="meta"):
        fused_bottleneck_layer(torch.zeros(1, 8, 8, 64, device="meta"), {"w1": []})
    before = fused_pairwise_cosine.launches
    fused_pairwise_cosine(torch.ones(2, 128), torch.ones(3, 128))
    assert fused_pairwise_cosine.launches == before  # the plain path counts nothing


@pytest.mark.parametrize("where", ["meta", "mixed"])
def test_flash_wrapper_refuses_foreign_devices(where):
    from incremental_multimodal_medical_learning_ii_torch.ops.flash_attention import (
        flash_attention,
    )

    q = torch.zeros(1, 2, 8, 64, device="meta")
    seg = torch.ones(1, 8, dtype=torch.int32, device="meta" if where == "meta" else "cpu")
    with pytest.raises(ValueError, match="meta"):
        flash_attention(q, q, q, seg, seg, 0.125)
    before = flash_attention.launches
    cpu, cpu_seg = torch.ones(1, 2, 8, 64), torch.ones(1, 8, dtype=torch.int32)
    out = flash_attention(cpu, cpu, cpu, cpu_seg, cpu_seg, 0.125)
    assert out.shape == cpu.shape and flash_attention.launches == before


def test_text_engine_refuses_without_cuda(monkeypatch, tmp_path):
    from incremental_multimodal_medical_learning_ii_torch.models.cxr_bert import (
        init_cxr_bert,
        tiny_bert_dims,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.engine import TextInferenceEngine
    from incremental_multimodal_medical_learning_ii_torch.text.tokenizer import (
        PromptTokenizer,
        write_test_vocab,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = init_cxr_bert(dims=tiny_bert_dims())
    tokenizer = PromptTokenizer(write_test_vocab(tmp_path / "vocab.txt"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TextInferenceEngine(model, tokenizer)
    assert TextInferenceEngine(model, tokenizer, device="cpu").device.type == "cpu"


def test_kernel_build_is_lazy_and_named_by_content():
    """Nothing builds at import; the library name follows the source."""
    from incremental_multimodal_medical_learning_ii_torch.ops import cuda_build

    assert set(cuda_build.SOURCES) == {"fused_cosine", "fused_bottleneck", "flash_attention",
                                       "flash_attention_bwd", "conv_epilogue"}
    for name, src in cuda_build.SOURCES.items():
        assert (cuda_build.CSRC_DIR / src).exists()
        path = cuda_build.library_path(name)
        assert path.parent == cuda_build.BUILD_DIR and path.name.startswith(name + "-")
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` header renames (so rebuilds) every kernel's
    library, not only an edited source."""
    import shutil

    from incremental_multimodal_medical_learning_ii_torch.ops import cuda_build

    assert sorted(cuda_build.CSRC_DIR.glob("*.cuh")), "no shared header in csrc/"
    for f in cuda_build.CSRC_DIR.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    before = {name: cuda_build.library_path(name) for name in cuda_build.SOURCES}
    header = sorted(tmp_path.glob("*.cuh"))[0]
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: cuda_build.library_path(name) for name in cuda_build.SOURCES}
    assert all(before[n] != after[n] for n in cuda_build.SOURCES)


@pytest.mark.parametrize("module,symbol", [
    ("fused_cosine", "fused_cosine_launch"),
    ("fused_bottleneck", "bottleneck_block_launch"),
    ("flash_attention", "flash_attention_launch"),
    ("conv_epilogue", "conv_epilogue_launch"),
])
def test_launcher_signatures_match_the_bound_argtypes(module, symbol):
    """A wrapper binds its launcher's ``argtypes`` once (ctypes checks
    nothing against the C side): their number is the C launcher's."""
    import importlib
    import re

    from incremental_multimodal_medical_learning_ii_torch.ops import cuda_build

    src = (cuda_build.CSRC_DIR / cuda_build.SOURCES[module]).read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
    assert m, f"{symbol} not in {cuda_build.SOURCES[module]}"
    wrapper = importlib.import_module(f"incremental_multimodal_medical_learning_ii_torch.ops.{module}")
    assert len(m.group(1).split(",")) == len(wrapper._ARGTYPES)


@pytest.mark.parametrize("entry", ["cli.sweep", "run_vmapped_sweep", "create_mesh_2d",
                                   "dryrun_multichip"])
def test_sweep_and_partitions_refuse_without_cuda(monkeypatch, entry):
    """The sweep, its CLI, the 2-D meshes and the dry run ask for CUDA
    unless given the CPU; no rank is started."""
    from incremental_multimodal_medical_learning_ii_torch.cli import sweep as cli
    from incremental_multimodal_medical_learning_ii_torch.data.store import synthetic_dataset
    from incremental_multimodal_medical_learning_ii_torch.engine.sweep import run_vmapped_sweep
    from incremental_multimodal_medical_learning_ii_torch.multichip import dryrun_multichip
    from incremental_multimodal_medical_learning_ii_torch.parallel.tp import create_mesh_2d
    from incremental_multimodal_medical_learning_ii_torch.text.bank import (
        build_prompt_bank,
        synthetic_encode_fn,
    )
    from incremental_multimodal_medical_learning_ii_torch.text.prompts import create_prompts
    from incremental_multimodal_medical_learning_ii_torch.utils.config import (
        CHEXPERT_COMPETITION_TASKS,
        ExperimentConfig,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "cli.sweep":
            cli.main(["--synthetic", "--epochs", "1", "--lrs", "1e-3", "--optims", "adam",
                      "--adapters", "mlp", "--prompt-modes", "mean", "--vmap"])
        elif entry == "run_vmapped_sweep":
            bank = build_prompt_bank(synthetic_encode_fn(),
                                     create_prompts(CHEXPERT_COMPETITION_TASKS),
                                     CHEXPERT_COMPETITION_TASKS)
            run_vmapped_sweep([ExperimentConfig(epochs=1, plot_figures="off")],
                              synthetic_dataset(64, seed=1), synthetic_dataset(64, seed=2), bank)
        elif entry == "create_mesh_2d":
            create_mesh_2d(1, 1)
        else:
            dryrun_multichip(2)
    from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import current_mesh

    assert current_mesh() is None
