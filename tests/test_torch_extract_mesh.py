"""``engine/extract.py::extract_embeddings(mesh=)`` at two gloo ranks on
the CPU against the JAX package's on ``create_mesh(2)``, in the setup of
tests/test_extract.py::test_extract_on_mesh (8 images of mixed shapes,
batch 8, 64^2, fp32); rank 0's shards, and a cut run resumed bit for bit
the clean one; a manifest's stream that decodes only each rank's slices."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_tpu.engine import extract as jex
from incremental_multimodal_medical_learning_ii_tpu.parallel.mesh import create_mesh as j_mesh
from incremental_multimodal_medical_learning_ii_torch.convert import params_from_jax
from incremental_multimodal_medical_learning_ii_torch.data.manifest import (
    ChexpertManifest as TManifest,
)
from incremental_multimodal_medical_learning_ii_torch.engine import extract as tex
from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import Mesh, spawn_ranks
from incremental_multimodal_medical_learning_ii_torch.utils.config import (
    CHEXPERT_COMPETITION_TASKS,
)

from torch_port_helpers import (  # noqa: F401
    assert_parity,
    biovil_numpy_params_from_port,
    extract_manifest_on_rank,
    extract_on_rank,
    one_torch_thread,
)

EMB_ATOL = 2e-4  # the ResNet bar
KW = dict(batch_size=8, size=64, pad_to=128, checkpoint_interval=8)
CUT = 8


def _images(n, seed=27, h=100, w=80):
    """tests/test_extract.py's images: heights 100-102, so mixed shapes."""
    rng = np.random.default_rng(seed)
    return [((rng.random((h + i % 3, w)) * 255).astype(np.uint8),
             (rng.random(5) < 0.5).astype(np.float32)) for i in range(n)]


@pytest.fixture(scope="module")
def tree():
    return biovil_numpy_params_from_port(seed=1, bn_seed=4)


@pytest.fixture(scope="module")
def ranks(tree, tmp_path_factory):
    return spawn_ranks(extract_on_rank, 2, "cpu", tree, _images(20), KW,
                       str(tmp_path_factory.mktemp("stores")), CUT)


def test_two_ranks_match_the_jax_mesh(ranks, tree):
    imgs = _images(8)
    ref = jex.extract_embeddings(iter(imgs), jax.tree_util.tree_map(jnp.asarray, tree),
                                 dtype=jnp.float32, mesh=j_mesh(2), **KW).embeddings
    for rank in ranks:
        assert rank["plain"].shape == (20, 128)
        assert_parity("extract mesh", rank["plain"][:8], ref, EMB_ATOL)
    np.testing.assert_array_equal(ranks[0]["plain"], ranks[1]["plain"])


def test_rank_zero_writes_and_a_resumed_run_is_bit_exact(ranks):
    r0, r1 = ranks
    for rank in (r0, r1):
        np.testing.assert_array_equal(rank["clean"], rank["plain"])
        np.testing.assert_array_equal(rank["resumed"], rank["clean"])
    # one writer: both ranks read back rank 0's shards, the clean run's rows
    np.testing.assert_array_equal(r0["clean_rows"], r0["clean"])
    np.testing.assert_array_equal(r0["cut_rows"], r0["clean"])


def test_batch_not_divisible_by_the_mesh_raises(tree):
    imgs = _images(2)
    kw = dict(KW, batch_size=3)
    with pytest.raises(ValueError) as jerr:
        jex.extract_embeddings(iter(imgs), jax.tree_util.tree_map(jnp.asarray, tree),
                               dtype=jnp.float32, mesh=j_mesh(2), **kw)
    mesh = Mesh(rank=0, size=2, device=torch.device("cpu"), backend="gloo", group=None)
    with pytest.raises(ValueError) as terr:
        tex.extract_embeddings(iter(imgs), params_from_jax(tree), dtype=torch.float32,
                               mesh=mesh, **kw)
    assert str(terr.value) == str(jerr.value) == \
        "batch_size=3 not divisible by the mesh's 2 data shards"


# a manifest of 10 PNGs at batch 4 over two ranks: the first batch of one
# shape (the shared-size path), the others mixed (the indexed path), the
# last one ragged (2 images: rank 1's slice is all padding)
MANIFEST_N, MANIFEST_BS, MANIFEST_CUT = 10, 4, 4


@pytest.fixture(scope="module")
def manifest_ranks(tree, tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("manifest")
    rows = []
    for i, (img, lbl) in enumerate(_images(MANIFEST_N)):
        if i < MANIFEST_BS:
            img = img[:100]
        Image.fromarray(img, "L").save(d / f"img_{i}.png")
        rows.append([f"img_{i}.png", *lbl.astype(int)])
    with open(d / "labels.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Path", *CHEXPERT_COMPETITION_TASKS])
        w.writerows(rows)
    kw = dict(KW, batch_size=MANIFEST_BS, checkpoint_interval=MANIFEST_BS)
    ranks = spawn_ranks(extract_manifest_on_rank, 2, "cpu", tree, str(d / "labels.csv"),
                        str(d) + "/", kw, str(tmp_path_factory.mktemp("cut")), MANIFEST_CUT)
    plain = tex.extract_embeddings(
        tex.manifest_image_iterator(TManifest.from_csv(d / "labels.csv", img_dir=str(d) + "/")),
        params_from_jax(tree), dtype=torch.float32, device="cpu", **kw).embeddings
    return ranks, plain


def test_each_rank_decodes_only_its_slices(manifest_ranks):
    ranks, plain = manifest_ranks
    # rank r's slice of each batch of 4: positions 2r, 2r + 1
    for r, rank in enumerate(ranks):
        want = [f"img_{j}.png" for j in range(MANIFEST_N) if j % MANIFEST_BS // 2 == r]
        assert rank["sliced_decoded"] == want
        assert rank["resumed_decoded"] == [n for n in want if int(n[4:-4]) >= MANIFEST_CUT]
        # the stand-ins change nothing: bit for bit the run that decodes all
        np.testing.assert_array_equal(rank["sliced"], rank["full"])
        np.testing.assert_array_equal(rank["resumed"], rank["full"])
        assert_parity("extract mesh manifest", rank["sliced"], plain, EMB_ATOL)
        # resuming after a part batch shifts an iterable's positions: refused
        assert rank["ragged_iterable_resume"] == (
            f"resuming at {MANIFEST_CUT + 1} images, not a multiple of batch_size="
            f"{MANIFEST_BS}, on a mesh needs images as a callable of the skip")
