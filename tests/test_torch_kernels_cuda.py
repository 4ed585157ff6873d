"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The pytest twin of chip_smoke.py's kernel phase. CUDA kernels have no CPU
mode, so every test here is marked `cuda` and skips without a GPU. On a
machine with one (and nvcc), run:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX, which this file does not use.)
"""

import pytest
import torch

from avsync_torch.ops.cuda import convpool, gru, mfcc

pytestmark = pytest.mark.cuda

K1_TOL = dict(atol=1e-4, rtol=1e-4)  # as tests/test_pallas_convpool.py
K2_TOL = dict(atol=1e-5, rtol=1e-4)  # as tests/test_pallas_gru.py
K3_TOL = dict(atol=1e-5, rtol=1e-4)  # dgi: as tests/test_pallas_gru.py
# dW_hh, db_hh: sums over B*T = 600 (row, step) terms in another order than
# the plain version's per-step matmuls
K3_SUM_TOL = dict(atol=1e-4, rtol=1e-4)
# dW, db of the conv1 block: sums over up to B*T*H/2*W/2 = 750,000 routed
# positions (atol 1e-3 / rtol 1e-4 as tests/test_pallas_convpool.py)
K4_TOL = dict(atol=1e-3, rtol=1e-4)
K5_TOL = dict(atol=1e-4, rtol=1e-5)  # as tests/test_pallas_mfcc.py:31


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
    (2, 4, 12, 70, (1, 3, 5), 7), (1, 1, 2, 2, (3, 5, 5), 32),
    # the tile's edges: a 27 x 51 pooled frame the 5 x 51 tile does not
    # divide; C = 20 and 9 (one ragged channel block); a 100-wide pooled
    # frame (two column tiles); 77 frames against 52 chunks
    (2, 5, 54, 102, (3, 5, 5), 32), (1, 3, 50, 100, (3, 5, 5), 20),
    (1, 3, 50, 100, (3, 5, 5), 9), (1, 2, 20, 200, (3, 5, 5), 9),
    (7, 11, 50, 100, (3, 5, 5), 32),
    # the batch sizes users train at (--batch_size 32, the JAX bench's 128)
    (32, 75, 50, 100, (3, 5, 5), 32), (128, 75, 50, 100, (3, 5, 5), 32)])
def test_conv1_pool_matches_plain(dev, B, T, H, W, k, C):
    """Within K1_TOL of the plain version in both layouts; a repeat launch
    gives the same bits."""
    g = _gen(1)
    x = torch.rand(B, T, H, W, 1, generator=g).to(dev)
    w = (torch.rand(*k, 1, C, generator=g) - 0.5).to(dev)
    b = (torch.rand(C, generator=g) - 0.5).to(dev)
    want = convpool.conv1_pool_ref(x, w, b)
    before = convpool.launches
    got = convpool.conv1_pool_fused(x, w, b)
    got_n = convpool.conv1_pool_block(x.permute(0, 4, 1, 2, 3),
                                      w.permute(4, 3, 0, 1, 2).contiguous(), b)
    again = convpool.conv1_pool_fused(x, w, b)
    torch.cuda.synchronize()
    assert convpool.launches == before + 3
    torch.testing.assert_close(got, want, **K1_TOL)
    torch.testing.assert_close(got_n, want.permute(0, 4, 1, 2, 3), **K1_TOL)
    assert torch.equal(got, again)


def test_conv1_pool_equals_plain_bit_for_bit_at_full_width(dev):
    """At B=8, T=75, 50x100, C=32 the kernel and the plain version run the
    same fmaf chain per pre-pool value: equal bits, not merely close."""
    g = _gen(17)
    x = torch.rand(8, 75, 50, 100, 1, generator=g).to(dev)
    w = ((torch.rand(3, 5, 5, 1, 32, generator=g) * 2 - 1) * 0.115).to(dev)
    b = ((torch.rand(32, generator=g) * 2 - 1) * 0.115).to(dev)
    got = convpool.conv1_pool_block(x.permute(0, 4, 1, 2, 3),
                                    w.permute(4, 3, 0, 1, 2).contiguous(), b)
    assert torch.equal(got, convpool.conv1_pool_ref(x, w, b).permute(0, 4, 1, 2, 3))


@pytest.mark.parametrize("B,T,H", [(8, 75, 256), (3, 75, 256), (12, 9, 256), (1, 1, 256),
                                   (2, 5, 8), (1, 75, 256), (5, 75, 256), (7, 75, 256),
                                   (9, 75, 256), (16, 75, 256), (32, 75, 256),
                                   (128, 75, 256), (9, 6, 40),
                                   # the generic kernel (w_hh in shared memory, then
                                   # through L2) and a padded H
                                   (3, 7, 264), (5, 6, 512), (2, 9, 1024), (3, 8, 20)])
def test_gru_both_directions_match_plain(dev, B, T, H):
    """Every rows-per-cluster choice and ragged batch tile, H above 256 and
    H not a multiple of 8; a repeat launch gives the same bits (fixed-order
    sums, no float atomics)."""
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
    again = gru.bigru_recurrence(gf, gb, wf, wb, bf, bb)
    torch.cuda.synchronize()
    assert gru.launches == before + 2
    torch.testing.assert_close(got, want, **K2_TOL)
    assert torch.equal(got, again)


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
    """H = 10 (padded to 16) and H = 264 (the generic kernel) run and match
    the plain version; an H past the card's shared memory and a float64
    input raise."""
    g = _gen(18)
    for H in (10, 264):
        k = H ** -0.5
        gi = torch.randn(2, 3, 3 * H, generator=g).to(dev)
        w = ((torch.rand(H, 3 * H, generator=g) * 2 - 1) * k).to(dev)
        b = ((torch.rand(3 * H, generator=g) * 2 - 1) * k).to(dev)
        torch.testing.assert_close(gru.gru_recurrence(gi, w, b), gru.gru_recurrence_ref(gi, w, b),
                                   **K2_TOL)
    H = 40000  # h buffers of 2 x 8 x H/8 floats per CTA: past 227 KB
    zero = torch.zeros(1, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        gru.gru_recurrence(zero.expand(1, 2, 3 * H), zero.expand(H, 3 * H), zero.expand(3 * H))
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


def _gru_bwd_case(g, dev, B, T, H):
    k = H ** -0.5
    gi = torch.randn(B, T, 3 * H, generator=g).to(dev)
    w = ((torch.rand(H, 3 * H, generator=g) * 2 - 1) * k).to(dev)
    b = ((torch.rand(3 * H, generator=g) * 2 - 1) * k).to(dev)
    return gi, w, b


@pytest.mark.parametrize("B,T,H", [(1, 75, 256), (2, 75, 256), (4, 75, 256), (8, 75, 256),
                                   (8, 1, 256), (3, 7, 256), (2, 5, 8),
                                   # ragged batch tiles and every rows-per-cluster choice
                                   (3, 75, 256), (5, 75, 256), (7, 75, 256), (9, 75, 256),
                                   (12, 75, 256), (16, 75, 256),
                                   # the batch sizes users train at
                                   (32, 75, 256), (128, 75, 256),
                                   # the generic chain and a padded H
                                   (3, 7, 264), (5, 6, 512), (2, 5, 1024), (3, 8, 20)])
def test_gru_bwd_both_directions_match_plain(dev, B, T, H):
    g = _gen(7)
    (gf, wf, bf), (gb, wb, bb) = (_gru_bwd_case(g, dev, B, T, H) for _ in range(2))
    out = torch.cat([gru.gru_recurrence_ref(gf, wf, bf, False),
                     gru.gru_recurrence_ref(gb, wb, bb, True)], -1)
    cot = torch.randn(B, T, 2 * H, generator=g).to(dev)
    want_f = gru.gru_recurrence_bwd_ref(gf, out[..., :H], cot[..., :H], wf, bf, False)
    want_b = gru.gru_recurrence_bwd_ref(gb, out[..., H:], cot[..., H:], wb, bb, True)
    before = gru.bwd_launches
    got = gru.bigru_recurrence_bwd(gf, gb, out, cot, wf, wb, bf, bb)
    again = gru.bigru_recurrence_bwd(gf, gb, out, cot, wf, wb, bf, bb)
    torch.cuda.synchronize()
    assert gru.bwd_launches == before + 2
    for d, want in enumerate((want_f, want_b)):
        torch.testing.assert_close(got[d], want[0], **K3_TOL)
        torch.testing.assert_close(got[2 + d], want[1], **K3_SUM_TOL)
        torch.testing.assert_close(got[4 + d], want[2], **K3_SUM_TOL)
    for a, b in zip(got, again):  # no float atomics: a repeat is bit-identical
        assert torch.equal(a, b)


def test_gru_bwd_torch_layout_weight_gets_its_layout_back(dev):
    g = _gen(8)
    H = 256
    gi = torch.randn(4, 9, 3 * H, generator=g).to(dev)
    w_torch = (torch.rand(3 * H, H, generator=g) * 0.1 - 0.05).to(dev)
    b = (torch.rand(3 * H, generator=g) * 0.1).to(dev)
    out = gru.gru_recurrence_ref(gi, w_torch.t(), b, True)
    cot = torch.randn(4, 9, H, generator=g).to(dev)
    dgi, dw, db = gru.gru_recurrence_bwd(gi, out, cot, w_torch.t(), b, True)
    want = gru.gru_recurrence_bwd_ref(gi, out, cot, w_torch.t(), b, True)
    assert dw.stride() == w_torch.t().stride()
    torch.testing.assert_close(dgi, want[0], **K3_TOL)
    torch.testing.assert_close(dw, want[1], **K3_SUM_TOL)
    torch.testing.assert_close(db, want[2], **K3_SUM_TOL)


@pytest.mark.parametrize("B,T,H,W,k,C", [
    (1, 75, 50, 100, (3, 5, 5), 32), (2, 75, 50, 100, (3, 5, 5), 32),
    (4, 75, 50, 100, (3, 5, 5), 32), (8, 75, 50, 100, (3, 5, 5), 32),
    (3, 7, 10, 18, (3, 3, 3), 5), (2, 4, 12, 70, (1, 3, 5), 7), (1, 1, 2, 2, (3, 5, 5), 32),
    # a pooled frame (27 x 51) the 5 x 51 tile does not divide; 77 and 3 frames
    # against 52 and 88 chunks; C < 32 at full width; columns past one tile
    (2, 5, 54, 102, (3, 5, 5), 32), (7, 11, 50, 100, (3, 5, 5), 32),
    (1, 3, 50, 100, (3, 5, 5), 20), (1, 2, 20, 200, (3, 5, 5), 9),
    # the batch sizes users train at: a frame chunk sums ~185 frames at B=128
    (32, 75, 50, 100, (3, 5, 5), 32), (128, 75, 50, 100, (3, 5, 5), 32)])
def test_conv1_pool_bwd_matches_plain(dev, B, T, H, W, k, C):
    g = _gen(9)
    x = torch.rand(B, T, H, W, 1, generator=g).to(dev)
    w = (torch.rand(*k, 1, C, generator=g) - 0.5).to(dev)
    b = (torch.rand(C, generator=g) - 0.5).to(dev)
    cot = torch.randn(B, T, H // 2, W // 2, C, generator=g).to(dev)
    want = convpool.conv1_pool_bwd_ref(x, w, b, cot)
    before = convpool.bwd_launches
    got = convpool.conv1_pool_bwd(x, w, b, cot)
    x_n, w_n = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous()
    got_n = convpool.conv1_pool_block_bwd(x_n, w_n, b, cot.permute(0, 4, 1, 2, 3))
    again = convpool.conv1_pool_bwd(x, w, b, cot)
    torch.cuda.synchronize()
    assert convpool.bwd_launches == before + 3
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, **K4_TOL)
    torch.testing.assert_close(got_n[0], want[0].permute(4, 3, 0, 1, 2), **K4_TOL)
    torch.testing.assert_close(got_n[1], want[1], **K4_TOL)
    for a, r in zip(got, again):  # no float atomics: a repeat is bit-identical
        assert torch.equal(a, r)


def test_conv1_pool_bwd_tie_routes_to_the_first_position(dev):
    g = _gen(10)
    x = torch.ones(1, 3, 4, 4, 1, device=dev)
    w = (torch.rand(3, 3, 3, 1, 2, generator=g) - 0.2).to(dev)
    b = torch.rand(2, generator=g).to(dev)
    cot = 2 * convpool.conv1_pool_ref(x, w, b)
    got = convpool.conv1_pool_bwd(x, w, b, cot)
    want = convpool.conv1_pool_bwd_ref(x, w, b, cot)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-4)


def test_conv1_pool_bwd_near_ties_route_as_the_forward(dev):
    """A near-constant input (1 + 1e-7 noise) and weights of one sign: the
    four pre-pool values of most windows lie within a few ulp. dW/db match
    the plain version, and K4 routes exactly where K1 pooled a positive
    value: on a cotangent that is nonzero only there, db is its channel sum
    (a routing that differed would miss a whole cotangent value, ~1)."""
    g = _gen(16)
    B, T, H, W, C = 2, 6, 50, 100, 32
    x = (1.0 + 1e-7 * torch.rand(B, T, H, W, 1, generator=g)).to(dev)
    w = (0.01 + 0.001 * torch.rand(3, 5, 5, 1, C, generator=g)).to(dev)
    b = (torch.rand(C, generator=g) - 0.6).to(dev)
    pooled = convpool.conv1_pool_fused(x, w, b)
    cot = torch.randn(B, T, H // 2, W // 2, C, generator=g).to(dev) * (pooled > 0)
    got = convpool.conv1_pool_bwd(x, w, b, cot)
    want = convpool.conv1_pool_bwd_ref(x, w, b, cot)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, **K4_TOL)
    torch.testing.assert_close(got[1], cot.sum(dim=(0, 1, 2, 3)), **K4_TOL)
    assert 0 < int((pooled > 0).sum()) < pooled.numel()


def test_model_gradients_kernel_path_match_plain_path(dev):
    """Full-width LipNet, both kernel flags on: after loss.backward() every
    parameter has a finite gradient, and it matches the plain path's (same
    weights, same batch, dropout off) within 1e-3 of that gradient's
    largest magnitude (fp32 sums over up to 10^6 terms in another order)."""
    from avsync_torch.config import ModelConfig
    from avsync_torch.models import LipNet
    from avsync_torch.ops.ctc import ctc_loss_mean
    from avsync_torch.train.lipnet_trainer import fp32_step

    cfg = ModelConfig(use_pallas_gru=True, fused_conv_pool=True, dropout_rate=0.0)
    fast = LipNet(cfg, generator=_gen(11)).to(dev)
    plain = LipNet(ModelConfig(dropout_rate=0.0), generator=_gen(12)).to(dev)
    plain.load_state_dict(fast.state_dict())
    g = _gen(13)
    x = torch.rand(2, 75, 50, 100, 1, generator=g).to(dev)
    labels = torch.randint(1, 38, (2, 20), generator=g).to(dev)
    lengths = torch.tensor([20, 13])
    counts = (convpool.launches, convpool.bwd_launches, gru.launches, gru.bwd_launches)
    grads = []
    for m in (fast, plain):
        with fp32_step():
            ctc_loss_mean(m(x), labels, lengths).backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    torch.cuda.synchronize()
    after = (convpool.launches, convpool.bwd_launches, gru.launches, gru.bwd_launches)
    assert tuple(a - b for a, b in zip(after, counts)) == (1, 1, 2, 2)
    for name, want in grads[1].items():
        got = grads[0][name]
        assert got is not None and torch.isfinite(got).all(), name
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-3 * scale + 1e-7, name


def _mel_case(g, dev, B, F, sr, n_fft, M, C, dense=False):
    from avsync_torch.ops import audio_ref

    melT = torch.from_numpy(audio_ref.mel_filterbank(sr, n_fft, M).astype("float32").T.copy())
    if dense:
        melT = torch.rand(melT.shape, generator=g) * 0.05
    dctT = torch.from_numpy(audio_ref.dct_ortho_matrix(C, M).astype("float32").T.copy())
    K = n_fft // 2 + 1
    power = (torch.rand(B, F, K, generator=g) ** 8
             * 10.0 ** (torch.rand(B, F, 1, generator=g) * 9 - 6))
    n = torch.tensor([(0, 1, 2, F, max(1, F // 2))[i % 5] for i in range(B)], dtype=torch.int32)
    return power.to(dev), n.to(dev), melT.to(dev), dctT.to(dev)


@pytest.mark.parametrize("B,F,sr,n_fft,M,C,dense", [
    (1, 121, 16000, 2048, 128, 20, False), (8, 121, 16000, 2048, 128, 20, False),
    (32, 121, 16000, 2048, 128, 20, False), (40, 121, 16000, 2048, 128, 20, False),
    (5, 21, 8000, 256, 40, 13, False), (3, 1, 8000, 256, 40, 13, False),
    (5, 21, 8000, 256, 40, 13, True),
    # long audio: 10 s and 30 s of 16 kHz (two slab buffers per CTA)
    (8, 401, 16000, 2048, 128, 20, False), (8, 1201, 16000, 2048, 128, 20, False)])
def test_mel_stats_matches_plain(dev, B, F, sr, n_fft, M, C, dense):
    """n_valid cycles through 0, 1, 2, F and a partial count; a repeat
    launch gives the same bits (fixed-order reductions, no float atomics)."""
    power, n, melT, dctT = _mel_case(_gen(14), dev, B, F, sr, n_fft, M, C, dense)
    want = mfcc.mel_stats_ref(power, n, melT, dctT)
    before = mfcc.launches
    got = mfcc.mel_stats(power, n, melT, dctT)
    again = mfcc.mel_stats(power, n, melT, dctT)
    torch.cuda.synchronize()
    assert mfcc.launches == before + 2
    torch.testing.assert_close(got, want, **K5_TOL)
    assert torch.equal(got, again)
    assert torch.isfinite(got).all() and not got[n == 0].any()


def test_mel_stats_clip_bits_do_not_depend_on_the_batch(dev):
    """A clip's statistics are the same bits whether it rides alone or in a
    batch of 32 or 512: the cluster and its row slices depend on the shape
    alone."""
    power, n, melT, dctT = _mel_case(_gen(19), dev, 512, 121, 16000, 2048, 128, 20)
    full = mfcc.mel_stats(power, n, melT, dctT)
    part = mfcc.mel_stats(power[:32], n[:32], melT, dctT)
    for i in (0, 3, 4, 31):
        one = mfcc.mel_stats(power[i:i + 1], n[i:i + 1], melT, dctT)
        assert torch.equal(one[0], part[i]) and torch.equal(one[0], full[i])
    assert torch.equal(part, full[:32])


@pytest.mark.parametrize("max_audio_samples", [48000, 160000])
def test_audio_stats_on_the_card_go_through_k5_only(dev, monkeypatch, max_audio_samples):
    """`audio_stats(use_pallas=True)` on a CUDA tensor launches K5 and never
    reaches the plain version; it agrees with the XLA-path composition."""
    import dataclasses

    from avsync_torch.config import AudioConfig
    from avsync_torch.ops import audio

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on the card")

    g = _gen(15)
    S = max_audio_samples  # 160,000: 401 frames, which the one-CTA-per-clip kernel refused
    x = (torch.rand(6, S, generator=g) - 0.5).to(dev)
    lengths = torch.tensor([S, 30000, 0, 400, 399, 1], dtype=torch.int32).to(dev)
    cfg = AudioConfig(use_pallas=True, max_audio_samples=S)
    monkeypatch.setattr(mfcc, "mel_stats_ref", refuse)
    before = mfcc.launches
    got = audio.audio_stats(x, lengths, cfg)
    torch.cuda.synchronize()
    assert mfcc.launches == before + 1
    monkeypatch.undo()
    want = audio.audio_stats(x, lengths, dataclasses.replace(cfg, use_pallas=False))
    torch.testing.assert_close(got, want, **K5_TOL)


def test_mel_stats_refuses_what_the_kernel_does_not_take(dev):
    melT = torch.rand(60000, 4, device=dev)
    dctT = torch.rand(4, 2, device=dev)
    n = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        mfcc.mel_stats(torch.rand(1, 3, 60000, device=dev), n, melT, dctT)
    # past the most frames a cluster's shared memory holds at the detector's shape
    F = mfcc.max_frames(1025, 128, 20) + 1
    with pytest.raises(ValueError, match=f"F={F} frames.*shared memory.*F <= {F - 1}"):
        mfcc.mel_stats(torch.zeros(1, F, 1025, device=dev), n, torch.rand(1025, 128, device=dev),
                       torch.rand(128, 20, device=dev))
    with pytest.raises(ValueError, match="int32"):
        mfcc.mel_stats(torch.rand(1, 3, 60000, device=dev), n.long(), melT, dctT)
