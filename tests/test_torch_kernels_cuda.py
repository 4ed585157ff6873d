"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The pytest twin of chip_smoke.py's kernel phase. CUDA kernels have no CPU
mode, so every test here is marked `cuda` and skips without a GPU. On a
machine with one (and nvcc), run:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX, which this file does not use.)
"""

import pytest
import torch

from avsync_torch.ops.cuda import convpool, gru

pytestmark = pytest.mark.cuda

K1_TOL = dict(atol=1e-4, rtol=1e-4)  # as tests/test_pallas_convpool.py
K2_TOL = dict(atol=1e-5, rtol=1e-4)  # as tests/test_pallas_gru.py


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("B,T,H,W,k,C", [
    (8, 75, 50, 100, (3, 5, 5), 32), (3, 7, 10, 18, (3, 3, 3), 5),
    (2, 4, 12, 70, (1, 3, 5), 7), (1, 1, 2, 2, (3, 5, 5), 32)])
def test_conv1_pool_matches_plain(dev, B, T, H, W, k, C):
    g = _gen(1)
    x = torch.rand(B, T, H, W, 1, generator=g).to(dev)
    w = (torch.rand(*k, 1, C, generator=g) - 0.5).to(dev)
    b = (torch.rand(C, generator=g) - 0.5).to(dev)
    want = convpool.conv1_pool_ref(x, w, b)
    before = convpool.launches
    got = convpool.conv1_pool_fused(x, w, b)
    got_n = convpool.conv1_pool_block(x.permute(0, 4, 1, 2, 3),
                                      w.permute(4, 3, 0, 1, 2).contiguous(), b)
    torch.cuda.synchronize()
    assert convpool.launches == before + 2
    torch.testing.assert_close(got, want, **K1_TOL)
    torch.testing.assert_close(got_n, want.permute(0, 4, 1, 2, 3), **K1_TOL)


@pytest.mark.parametrize("B,T,H", [(8, 75, 256), (3, 75, 256), (12, 9, 256), (1, 1, 256),
                                   (2, 5, 8)])
def test_gru_both_directions_match_plain(dev, B, T, H):
    g = _gen(2)
    k = H ** -0.5
    args = []
    for _ in range(2):
        args.append((torch.randn(B, T, 3 * H, generator=g).to(dev),
                     ((torch.rand(H, 3 * H, generator=g) * 2 - 1) * k).to(dev),
                     ((torch.rand(3 * H, generator=g) * 2 - 1) * k).to(dev)))
    (gf, wf, bf), (gb, wb, bb) = args
    want = torch.cat([gru.gru_recurrence_ref(gf, wf, bf, False),
                      gru.gru_recurrence_ref(gb, wb, bb, True)], -1)
    before = gru.launches
    got = gru.bigru_recurrence(gf, gb, wf, wb, bf, bb)
    torch.cuda.synchronize()
    assert gru.launches == before + 1
    torch.testing.assert_close(got, want, **K2_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_single_direction_with_strided_weights(dev, reverse):
    g = _gen(3)
    H = 256
    gi = torch.randn(4, 7, 3 * H, generator=g).to(dev)
    w_torch = (torch.rand(3 * H, H, generator=g) * 0.1 - 0.05).to(dev)  # (3H, H)
    b = (torch.rand(3 * H, generator=g) * 0.1).to(dev)
    got = gru.gru_recurrence(gi, w_torch.t(), b, reverse)
    torch.testing.assert_close(got, gru.gru_recurrence_ref(gi, w_torch.t(), b, reverse),
                               **K2_TOL)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    gi = torch.randn(2, 3, 30, device=dev)  # H = 10, not a multiple of 8
    with pytest.raises(ValueError, match="divisible by 8"):
        gru.gru_recurrence(gi, torch.randn(10, 30, device=dev), torch.randn(30, device=dev))
    x = torch.rand(1, 2, 4, 4, 1, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        convpool.conv1_pool_fused(x, torch.rand(3, 3, 3, 1, 2, device=dev),
                                  torch.rand(2, device=dev))


def test_model_kernel_path_matches_plain_path(dev):
    from avsync_torch.config import ModelConfig
    from avsync_torch.models import LipNet

    cfg = ModelConfig(use_pallas_gru=True, fused_conv_pool=True)
    fast = LipNet(cfg, generator=_gen(4)).to(dev).eval()
    plain = LipNet(ModelConfig(), generator=_gen(5)).to(dev).eval()
    plain.load_state_dict(fast.state_dict())
    x = torch.rand(2, 75, 50, 100, 1, generator=_gen(6)).to(dev)
    k1, k2 = convpool.launches, gru.launches
    with torch.inference_mode():
        got, want = fast(x), plain(x)
    torch.cuda.synchronize()
    assert (convpool.launches - k1, gru.launches - k2) == (1, cfg.num_gru_layers)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
