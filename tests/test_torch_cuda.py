"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: on a host without a CUDA device every test here skips
(the ``cuda_device`` fixture decides at run time).  Imports neither JAX
nor the JAX package, so it runs on the card's machine as it is:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from repro_torch.core.bitmap import suffix_popcounts
from repro_torch.core.eclat import mine_bitmap
from repro_torch.data.transactions import gen_powerlaw_baskets
from repro_torch.kernels import ops
from repro_torch.kernels.bitmap_intersect import bitmap_intersect_es
from repro_torch.kernels.compact import compact_gather

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rows(rng, n, nb, bw, dev):
    u = rng.integers(0, 2 ** 32, (n, nb, bw), dtype=np.uint64)
    u &= rng.integers(0, 2 ** 32, (n, nb, bw), dtype=np.uint64)
    return torch.from_numpy(u.astype(np.uint32).view(np.int32)).to(dev)


@pytest.mark.parametrize("mode", ["and", "andnot"])
@pytest.mark.parametrize("nb,bw", [(9, 1), (7, 8), (3, 128)])
def test_scan_kernel_matches_plain(cuda_device, mode, nb, bw):
    rng = np.random.default_rng(0)
    U, V = _rows(rng, 17, nb, bw, cuda_device), _rows(rng, 17, nb, bw,
                                                      cuda_device)
    su, sv = suffix_popcounts(U), suffix_popcounts(V)
    rho = su[:, 0].contiguous()
    before = bitmap_intersect_es.launches
    for minsup in (-1, 0, 1, nb * bw * 4, nb * bw * 8):
        got = ops.bitmap_intersect_es(U, V, su, sv, rho, minsup, mode=mode)
        want = ops.bitmap_intersect_es(U, V, su, sv, rho, minsup, mode=mode,
                                       backend="plain")
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w), (mode, minsup)
    assert bitmap_intersect_es.launches == before + 5


@pytest.mark.parametrize("es", [True, False])
def test_fused_kernel_matches_plain(cuda_device, es):
    rng = np.random.default_rng(1)
    slab = _rows(rng, 40, 5, 8, cuda_device)
    suf = suffix_popcounts(slab)
    ua = np.arange(0, 10, dtype=np.int32)
    vb = np.arange(5, 15, dtype=np.int32)
    slots = np.arange(20, 30, dtype=np.int32)
    slots[-1] = 40                                  # pad slot: skipped
    rho = np.zeros(10, np.int32)
    for minsup in (1, 200, 400):
        rk, sk, rp, sp = slab.clone(), suf.clone(), slab.clone(), suf.clone()
        got = ops.screen_and_intersect(rk, sk, ua, vb, slots, rho, minsup,
                                       early_stop=es)
        want = ops.screen_and_intersect(rp, sp, ua, vb, slots, rho, minsup,
                                        early_stop=es, backend="plain")
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w), minsup


def test_compact_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(2)
    perm = torch.tensor([3, -1, 0, 40, 7, 39, -5], dtype=torch.int32,
                        device=cuda_device)
    for slab in (_rows(rng, 40, 3, 8, cuda_device),
                 _rows(rng, 40, 1, 3, cuda_device)[:, 0].contiguous(),
                 suffix_popcounts(_rows(rng, 40, 6, 128, cuda_device))):
        before = compact_gather.launches
        got = compact_gather(slab, perm)
        assert compact_gather.launches == before + 1
        assert torch.equal(got, ops.compact_rows(slab, slab, perm,
                                                 backend="plain")[0])


def test_miner_on_card_equals_cpu(cuda_device):
    db = gen_powerlaw_baskets(n_trans=300, n_items=200, avg_trans_len=6,
                              seed=0)
    out_c, st_c = mine_bitmap(db, 3, block_words=8, device=cuda_device)
    out_p, st_p = mine_bitmap(db, 3, block_words=8, device="cpu")
    assert out_c == out_p and len(out_c) == 1687
    times = {"runtime_s", "assemble_s", "resolve_s"}
    assert ({k: v for k, v in st_c.as_dict().items() if k not in times}
            == {k: v for k, v in st_p.as_dict().items() if k not in times})


def test_purity_guard_raises_on_a_host_sync(cuda_device):
    """On CUDA the guard has teeth: a readback outside host_sync raises,
    one inside it does not, and the previous mode comes back."""
    from repro_torch.core.guards import device_purity_guard, host_sync

    x = torch.ones(4, device=cuda_device)
    before = torch.cuda.get_sync_debug_mode()
    with device_purity_guard():
        with pytest.raises(RuntimeError):
            x.sum().item()
        with host_sync("test readback"):
            assert x.sum().item() == 4.0
    assert torch.cuda.get_sync_debug_mode() == before
