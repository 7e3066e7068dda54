"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels build from
``src/repro_torch/kernels/csrc`` at first use); elsewhere they skip.
Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed. Outputs are integers: equality is exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bindjoin as tbindjoin
from repro_torch.kernels.tpf_match import tpf_match_cuda, tpf_match_plain


def rand_triples(rng, t, terms=6):
    return rng.integers(0, terms, size=(t, 3)).astype(np.int32)


def rand_patterns(rng, shape, terms=6, wild_frac=0.4):
    pats = rng.integers(0, terms, size=(*shape, 3)).astype(np.int32)
    pats[rng.random((*shape, 3)) < wild_frac] = -1
    return pats


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnCard:
    """Each hand-written kernel against its plain version on the card."""

    def test_tpf_match(self, cuda_device):
        rng = np.random.default_rng(31)
        cand = [torch.as_tensor(c, device=cuda_device)
                for c in rand_triples(rng, 70001, terms=3).T.copy()]
        for vec in [(-1, -1, -1, 0, 0, 0), (1, -1, -1, 0, 1, 0),
                    (-1, 2, -1, 0, 0, 0), (-1, -1, -1, 1, 1, 1)]:
            pv = torch.tensor([*vec, 0, 0], dtype=torch.int32,
                              device=cuda_device)
            got = tpf_match_cuda(*cand, pv)
            want = tpf_match_plain(*cand, pv)
            torch.cuda.synchronize()
            assert torch.equal(got, want)

    @pytest.mark.parametrize("t,g,mp", [(1000, 1, 128), (4096, 3, 256),
                                        (300, 8, 384)])
    def test_bindjoin_grouped(self, cuda_device, t, g, mp):
        rng = np.random.default_rng(t + g + mp)
        cand = [torch.as_tensor(c, device=cuda_device)
                for c in rand_triples(rng, t).T.copy()]
        flat = [torch.as_tensor(c, device=cuda_device)
                for c in rand_patterns(rng, (g * mp,)).T.copy()]
        pv = torch.as_tensor((rng.random(g * mp) < 0.7).astype(np.int32),
                             device=cuda_device)
        got = tbindjoin.bindjoin_grouped_cuda(*cand, *flat, pv, groups=g)
        want = tbindjoin.bindjoin_grouped_plain(*cand, *flat, pv, groups=g)
        torch.cuda.synchronize()
        for w, o in zip(want, got, strict=True):
            assert torch.equal(w, o)

    def test_bindjoin_fused(self, cuda_device):
        rng = np.random.default_rng(41)
        s, g, mp, tiles = 4, 2, 384, 12
        cand = [torch.as_tensor(c, device=cuda_device)
                for c in rand_triples(rng, tiles * 256).T.copy()]
        seg = rng.integers(-1, s, size=tiles).astype(np.int32)
        flat = [torch.as_tensor(c, device=cuda_device)
                for c in rand_patterns(rng, (s * g * mp,)).T.copy()]
        pv = torch.as_tensor((rng.random(s * g * mp) < 0.7).astype(np.int32),
                             device=cuda_device)
        seg_d = torch.as_tensor(seg, device=cuda_device)
        got = tbindjoin.bindjoin_fused_cuda(seg_d, *cand, *flat, pv,
                                            segments=s, groups=g)
        want = tbindjoin.bindjoin_fused_plain(seg_d, *cand, *flat, pv,
                                              segments=s, groups=g)
        torch.cuda.synchronize()
        for w, o in zip(want, got, strict=True):
            assert torch.equal(w, o)
