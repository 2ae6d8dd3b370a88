"""The port's vote-NMS (radet_tpu_torch/ops/vote_nms.py) against the JAX
package: the Pallas kernel in interpret mode, the XLA formulation
``vote_nms_device_fast(presorted=True)`` and the sequential numpy oracle.

Tolerances are those of tests/test_pallas_nms.py: boxes rtol 1e-3 /
atol 1e-2 px against the float64 oracle (float32 vote sums), labels and keep
sets exact, scores rtol 1e-5 (they are copied, not computed).

The kernel-vs-plain cases need a CUDA card and skip without one.  The card's
machine has no JAX, so this module imports JAX only inside the tests that
compare with it; run the card's cases there with
``python -m pytest --noconftest -m cuda tests/test_torch_vote_nms.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import radet_tpu_torch.ops.vote_nms_cuda as cuda_mod
from radet_tpu_torch.ops.vote_nms import vote_nms, vote_nms_plain

THR = 0.5


def _sorted_dets(rng, n_real, num_labels=3, k=128):
    """Clustered candidates sorted by cluster score, invalid slots last (as
    tests/test_pallas_nms.py makes them)."""
    centers = rng.uniform(50, 400, (8, 2))
    idx = rng.randint(0, 8, n_real)
    cx = centers[idx, 0] + rng.randn(n_real) * 3
    cy = centers[idx, 1] + rng.randn(n_real) * 3
    w = rng.uniform(40, 60, n_real)
    h = rng.uniform(40, 60, n_real)
    boxes = np.zeros((k, 4), np.float32)
    boxes[:n_real] = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    cluster = np.zeros(k, np.float32)
    cluster[:n_real] = np.sort(rng.uniform(0.1, 1.0, n_real))[::-1]
    vote = np.zeros(k, np.float32)
    vote[:n_real] = rng.uniform(0.1, 1.0, n_real)
    labels = np.zeros(k, np.int32)
    labels[:n_real] = (idx % num_labels).astype(np.int32)
    valid = np.zeros(k, bool)
    valid[:n_real] = True
    return boxes, cluster, vote, labels, valid


@pytest.fixture(scope="module")
def ref():
    """The JAX package's vote-NMS implementations."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from radet_tpu.ops.pallas_nms import vote_nms_pallas
    from radet_tpu.ops.vote_nms import vote_nms_device_fast, vote_nms_numpy
    from test_vote_nms import _random_dets

    def references(arrays, **kw):
        pallas = vote_nms_pallas(*(jnp.asarray(a) for a in arrays), interpret=True, **kw)
        fast = jax.vmap(lambda *xs: vote_nms_device_fast(*xs, presorted=True, **kw))(
            *(jnp.asarray(a) for a in arrays)
        )
        return [list(map(np.asarray, pallas)), list(map(np.asarray, fast))]

    return SimpleNamespace(references=references, oracle=vote_nms_numpy, random_dets=_random_dets)


def _presort(boxes, cluster, vote, labels):
    """Sort candidates by cluster score descending (the contract of the
    presorted NMS)."""
    order = np.argsort(-cluster, kind="stable")
    return boxes[order], cluster[order], vote[order], labels[order]


def _plain(arrays, **kw):
    boxes, cluster, vote, labels, valid = (torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    out = vote_nms_plain(boxes, cluster, vote, labels.to(torch.int32), valid.bool(), **kw)
    return [t.numpy() for t in out]


def _check_oracle(db, dl, dsc, dv, oracle, rtol=1e-3, atol=1e-2):
    ob, ol, osc = oracle
    n = int(dv.sum())
    assert n == min(len(ob), len(dv))
    assert dv[:n].all() and not dv[n:].any()
    np.testing.assert_allclose(db[:n], ob[:n], rtol=rtol, atol=atol)
    np.testing.assert_array_equal(dl[:n], ol[:n])
    np.testing.assert_allclose(dsc[:n], osc[:n], rtol=1e-5)
    assert (dl[n:] == -1).all() and (db[n:] == 0).all() and (dsc[n:] == 0).all()


def _check_same(a, b):
    """Two vote-NMS results: the same keep set, labels and scores; boxes to
    the oracle tolerance."""
    (ab, al, asc, av), (bb, bl, bsc, bv) = a, b
    np.testing.assert_array_equal(av, bv)
    np.testing.assert_array_equal(al, bl)
    np.testing.assert_array_equal(asc, bsc)
    np.testing.assert_allclose(ab, bb, rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("global_mode", [False, True])
@pytest.mark.parametrize("iou_enable", [False, True])
def test_plain_matches_jax_and_oracle(ref, rng, global_mode, iou_enable):
    kw = dict(iou_threshold=THR, max_out=50, iou_enable=iou_enable, sigma=0.025,
              global_mode=global_mode)
    images = [_sorted_dets(rng, n_real=60) for _ in range(3)]
    arrays = [np.stack(x) for x in zip(*images)]
    plain = _plain(arrays, **kw)
    for expected in ref.references(arrays, **kw):
        _check_same(plain, expected)
    for i, (boxes, cluster, vote, labels, _) in enumerate(images):
        oracle = ref.oracle(
            boxes[:60], cluster[:60], vote[:60], labels[:60], THR, iou_enable, 0.025, global_mode
        )
        _check_oracle(*(x[i] for x in plain), oracle)


@pytest.mark.parametrize("global_mode", [False, True])
def test_plain_multitile_matches_jax_and_oracle(ref, rng, global_mode):
    """K=256 with candidates spanning both of the TPU kernel's 128-tiles."""
    k, n = 256, 220
    kw = dict(iou_threshold=THR, max_out=100, global_mode=global_mode)
    boxes, cluster, vote, labels, valid = _sorted_dets(rng, n_real=n, k=k)
    arrays = [x[None] for x in (boxes, cluster, vote, labels, valid)]
    plain = _plain(arrays, **kw)
    for expected in ref.references(arrays, **kw):
        _check_same(plain, expected)
    oracle = ref.oracle(
        boxes[:n], cluster[:n], vote[:n], labels[:n], THR, False, 0.025, global_mode
    )
    _check_oracle(*(x[0] for x in plain), oracle)


def test_plain_empty_input():
    k = 128
    arrays = [np.zeros((2, k, 4), np.float32), np.zeros((2, k), np.float32),
              np.zeros((2, k), np.float32), np.zeros((2, k), np.int32), np.zeros((2, k), bool)]
    db, dl, dsc, dv = _plain(arrays, iou_threshold=0.65, max_out=10)
    assert db.shape == (2, 10, 4) and not dv.any()
    assert (dl == -1).all() and (db == 0).all() and (dsc == 0).all()


def test_plain_degenerate_box_self_membership(ref, rng):
    """A kept zero-area box emits its own coordinates (forced
    self-membership), as the Pallas kernel and the XLA formulation do."""
    boxes, cluster, vote, labels, valid = _sorted_dets(rng, n_real=20)
    boxes[3] = (77.0, 50.0, 77.0, 120.0)
    labels[3] = 2
    labels[:3] = 0
    kw = dict(iou_threshold=THR, max_out=50)
    arrays = [x[None] for x in (boxes, cluster, vote, labels, valid)]
    plain = _plain(arrays, **kw)
    for expected in ref.references(arrays, **kw):
        _check_same(plain, expected)
    db, _, _, dv = plain
    assert any(np.allclose(e, boxes[3], atol=1e-3) for e in db[0][dv[0]])


def test_plain_deep_chain(ref):
    """Chained overlaps (each box overlaps only its neighbours) need several
    rounds of the greedy fixed point."""
    n = 12
    boxes = np.stack(
        [10.0 * np.arange(n), np.zeros(n), 10.0 * np.arange(n) + 40, np.full(n, 40.0)], -1
    ).astype(np.float32)
    cluster = np.linspace(1.0, 0.5, n).astype(np.float32)
    vote = np.ones(n, np.float32)
    labels = np.zeros(n, np.int32)
    oracle = ref.oracle(boxes, cluster, vote, labels, THR, False, 0.025, False)
    arrays = [x[None] for x in (boxes, cluster, vote, labels, np.ones(n, bool))]
    plain = _plain(arrays, iou_threshold=THR, max_out=12)
    _check_oracle(*(x[0] for x in plain), oracle, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n_valid", [40, 25])
def test_plain_truncation(ref, rng, n_valid):
    """max_out below the number of clusters keeps the highest-scored ones;
    invalid slots never take part."""
    boxes, cluster, vote, labels = _presort(*ref.random_dets(rng, n=40))
    valid = np.arange(40) < n_valid
    oracle = ref.oracle(
        boxes[:n_valid], cluster[:n_valid], vote[:n_valid], labels[:n_valid],
        THR, False, 0.025, False,
    )
    assert len(oracle[0]) > 3
    arrays = [x[None] for x in (boxes, cluster, vote, labels, valid)]
    plain = _plain(arrays, iou_threshold=THR, max_out=3)
    _check_oracle(*(x[0] for x in plain), oracle)


def test_dispatch_cpu_runs_plain_and_kernel_wrapper_refuses_cpu():
    rng = np.random.RandomState(0)
    arrays = [np.stack(x) for x in zip(*[_sorted_dets(rng, n_real=30) for _ in range(2)])]
    tensors = [torch.from_numpy(a) for a in arrays]
    tensors[3] = tensors[3].to(torch.int32)
    before = cuda_mod.LAUNCHES
    out = vote_nms(*tensors, iou_threshold=THR, max_out=20)
    assert cuda_mod.LAUNCHES == before
    _check_same([t.numpy() for t in out], _plain(arrays, iou_threshold=THR, max_out=20))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mod.vote_nms_cuda(*tensors, iou_threshold=THR, max_out=20)


def _clustered_batch(rng, b, k, num_labels=5):
    """Synthetic clustered candidates, 60-100% valid, sorted per image."""
    images = []
    for _ in range(b):
        n_real = int(rng.randint(int(0.6 * k), k + 1))
        images.append(_sorted_dets(rng, n_real=n_real, num_labels=num_labels, k=k))
    return [np.stack(x) for x in zip(*images)]


def assert_kernel_matches_plain(kern, plain, tail=0.005, atol=1e-2):
    """Keep sets, labels and scores exact; boxes within ``atol`` px except a
    ``tail`` fraction of 1-sigma boundary flips.  Returns the max abs error."""
    kb, kl, ks, kv = (t.cpu().numpy() for t in kern)
    pb, pl, ps, pv = (t.cpu().numpy() for t in plain)
    np.testing.assert_array_equal(kv, pv)
    np.testing.assert_array_equal(kl, pl)
    np.testing.assert_array_equal(ks, ps)
    err = np.abs(kb - pb)[kv]
    assert (err > atol).mean() <= tail if err.size else True
    return float(err.max()) if err.size else 0.0


def test_kernel_size_check_takes_the_strict_eval_k():
    """The strict eval (apis/test.py::strict_eval_overrides) sends K = 2048
    candidates into vote-NMS, and the flagship's per-level candidate set at
    480x640 is 4 x 1000 + 420 = 4420: the kernel's size check takes both."""
    assert cuda_mod.MAX_K >= 8192
    for b, k in ((8, 2048), (16, 4420), (1, cuda_mod.MAX_K), (128, 512)):
        cuda_mod.check_sizes(b, k, 100)
    for b, k, m in ((1, cuda_mod.MAX_K + 1, 100), (0, 512, 100), (1, 0, 100), (1, 512, -1)):
        with pytest.raises(ValueError, match="MAX_K|max_out"):
            cuda_mod.check_sizes(b, k, m)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [128, 300, 512, 1024])
@pytest.mark.parametrize("global_mode", [False, True])
@pytest.mark.parametrize("iou_enable", [False, True])
def test_kernel_matches_plain(cuda_device, k, global_mode, iou_enable):
    rng = np.random.RandomState(k)
    arrays = _clustered_batch(rng, 16, k)
    tensors = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    tensors[3] = tensors[3].to(torch.int32)
    kw = dict(iou_threshold=0.65, max_out=100, iou_enable=iou_enable, sigma=0.025,
              global_mode=global_mode)
    before = cuda_mod.LAUNCHES
    kern = vote_nms(*tensors, **kw)
    torch.cuda.synchronize()
    assert cuda_mod.LAUNCHES == before + 1
    assert_kernel_matches_plain(kern, vote_nms_plain(*tensors, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1025, 2048, 4420])
@pytest.mark.parametrize("global_mode", [False, True])
def test_kernel_above_1024_matches_plain(cuda_device, k, global_mode):
    """The global-scratch instantiation (K > 1024), held to the plain version
    in float64 on the CPU.  At these cluster sizes (hundreds of members per
    seed) a float32 plain version is no steady reference: on the card (FMA
    contraction, scatter_add in atomic order) and on the CPU it strays from
    float64 on a few voted coordinates, not the same ones (0.0752 px on the
    CPU at K = 1025).  Keep sets, labels and scores are equal in float64
    too; the scores come back to float32 exactly (they are copied)."""
    rng = np.random.RandomState(k)
    arrays = _clustered_batch(rng, 16, k)
    tensors = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    tensors[3] = tensors[3].to(torch.int32)
    kw = dict(iou_threshold=0.65, max_out=100, global_mode=global_mode)
    before = cuda_mod.LAUNCHES
    kern = vote_nms(*tensors, **kw)
    torch.cuda.synchronize()
    assert cuda_mod.LAUNCHES == before + 1
    plain = vote_nms_plain(*(t.cpu().double() if t.is_floating_point() else t.cpu() for t in tensors), **kw)
    assert_kernel_matches_plain(kern, [t.float() if t.is_floating_point() else t for t in plain])


def _edge_cases():
    """Inputs at the kernel's edges: (arrays, kwargs) by name."""
    rng = np.random.RandomState(7)

    def one(*x):
        return [np.ascontiguousarray(a[None]) for a in x]

    empty = [np.zeros((2, 128, 4), np.float32), np.zeros((2, 128), np.float32),
             np.zeros((2, 128), np.float32), np.zeros((2, 128), np.int32), np.zeros((2, 128), bool)]
    boxes, cluster, vote, labels, valid = _sorted_dets(rng, n_real=20)
    boxes[3] = (77.0, 50.0, 77.0, 120.0)  # zero area, own label: kept, votes for itself
    labels[3] = 2
    labels[:3] = 0
    degenerate = one(boxes, cluster, vote, labels, valid)
    n = 12
    chain = one(
        np.stack([10.0 * np.arange(n), np.zeros(n), 10.0 * np.arange(n) + 40, np.full(n, 40.0)],
                 -1).astype(np.float32),
        np.linspace(1.0, 0.5, n).astype(np.float32), np.ones(n, np.float32),
        np.zeros(n, np.int32), np.ones(n, bool),
    )
    return {
        "empty": (empty, dict(max_out=10)),
        "single": ([a[:, :1] for a in _clustered_batch(rng, 3, 8)], dict(max_out=5)),
        "degenerate": (degenerate, dict(iou_threshold=THR, max_out=50)),
        "degenerate_iou_enable": (degenerate, dict(iou_threshold=THR, max_out=50, iou_enable=True)),
        "deep_chain": (chain, dict(iou_threshold=THR, max_out=12)),
        "truncation": (_clustered_batch(rng, 4, 256), dict(max_out=3)),
        "max_out_0": (_clustered_batch(rng, 2, 64), dict(max_out=0)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_edge_cases()))
def test_kernel_edge_cases_match_plain(cuda_device, case):
    arrays, kw = _edge_cases()[case]
    tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device) for a in arrays]
    tensors[3] = tensors[3].to(torch.int32)
    kern = vote_nms(*tensors, **kw)
    torch.cuda.synchronize()
    plain = vote_nms_plain(*tensors, **kw)
    assert kern[0].shape == plain[0].shape
    assert_kernel_matches_plain(kern, plain, tail=0.0)
