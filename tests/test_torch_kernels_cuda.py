"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The pytest twin of chip_smoke.py's kernel phase. CUDA kernels have no CPU
mode, so every test here is marked `cuda` and skips without a GPU. On a
machine with one (and nvcc), run:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX, which this file does not use.)
"""

import pytest
import torch

from avsync_torch.ops.cuda import build, convpool, gru, mfcc, quantconv

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


def _exact_grid(g, B, T, H, W, k, C, dev):
    """bf16 inputs on grids where every partial sum of the bf16 kernels'
    recompute (and of K4's dW at B=1, T=8) is exact in float32 in any order:
    x = i/16, w = j/64, b = k/64, g = m/8 (|j|, |k| <= 15, |m| <= 8)."""
    bf = torch.bfloat16
    x = (torch.randint(0, 16, (B, T, H, W, 1), generator=g) / 16).to(dev).to(bf)
    w = (torch.randint(-15, 16, (*k, 1, C), generator=g) / 64).to(dev).to(bf)
    b = (torch.randint(-15, 16, (C,), generator=g) / 64).to(dev)
    cot = (torch.randint(-8, 9, (B, T, H // 2, W // 2, C), generator=g) / 8).to(dev).to(bf)
    return x, w, b, cot


def _within_one_ulp(got, want):
    """|got - want| <= one bf16 ulp of want, the ulp taken at no less than
    2^-5 (2^-12 near 0, where the float32 sums' order alone moves a value by
    up to the near-tie bound); returns the share of elements that differ."""
    got, want = got.float(), want.float()
    mag = want.abs().clamp_min(2.0 ** -5)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert ((got - want).abs() <= ulp).all()
    return (got != want).float().mean().item()


BF16_SHAPES = [(8, 75, 50, 100, (3, 5, 5), 32), (128, 75, 50, 100, (3, 5, 5), 32),
               (3, 7, 10, 18, (3, 3, 3), 5), (2, 5, 54, 102, (3, 5, 5), 32),
               (1, 2, 20, 200, (3, 5, 5), 9)]


@pytest.mark.parametrize("B,T,H,W,k,C", BF16_SHAPES)
def test_conv1_pool_bf16_equals_plain_bit_for_bit(dev, B, T, H, W, k, C):
    """K1-bf16 on the tensor cores sums in its K order, not the plain
    version's tap order, so its bits equal the plain version's where the
    sums are exact: on exact-grid inputs, in both layouts (pooling ties,
    frequent there, check the first-match rule); clip 0 alone gives the
    bits of its slice of the batch; a repeat the same; one launch each."""
    x, w, b, _ = _exact_grid(_gen(21), B, T, H, W, k, C, dev)
    want = convpool.conv1_pool_ref(x, w, b)
    before = convpool.launches
    got = convpool.conv1_pool_fused(x, w, b)
    got_n = convpool.conv1_pool_block(x.permute(0, 4, 1, 2, 3),
                                      w.permute(4, 3, 0, 1, 2).contiguous().float(), b)
    again = convpool.conv1_pool_fused(x, w, b)
    one = convpool.conv1_pool_fused(x[:1], w, b)
    torch.cuda.synchronize()
    assert convpool.launches == before + 4
    assert got.dtype == got_n.dtype == torch.bfloat16
    assert torch.equal(got, want) and torch.equal(got_n, want.permute(0, 4, 1, 2, 3))
    assert torch.equal(got, again) and torch.equal(one, got[:1])


@pytest.mark.parametrize("B,T,H,W,k,C", BF16_SHAPES)
def test_conv1_pool_bf16_within_one_ulp_of_plain(dev, B, T, H, W, k, C):
    """On random data K1-bf16's pooled values are within one bf16 ulp of the
    plain version's (a reorder of the float32 sums flips a rounding now and
    then), and at most 1e-3 of them differ."""
    g = _gen(21)
    x = torch.rand(B, T, H, W, 1, generator=g).to(dev).to(torch.bfloat16)
    w = (torch.rand(*k, 1, C, generator=g) - 0.5).to(dev).to(torch.bfloat16)
    b = (torch.rand(C, generator=g) - 0.5).to(dev)
    share = _within_one_ulp(convpool.conv1_pool_fused(x, w, b), convpool.conv1_pool_ref(x, w, b))
    print(f"K1-bf16 B={B} {H}x{W} C={C}: {share:.2e} of the elements differ by one ulp")
    assert share <= 1e-3


@pytest.mark.parametrize("B,T,H,W,k,C", [
    (8, 75, 50, 100, (3, 5, 5), 32), (128, 75, 50, 100, (3, 5, 5), 32),
    (3, 7, 10, 18, (3, 3, 3), 5), (2, 5, 54, 102, (3, 5, 5), 32)])
def test_conv1_pool_bwd_bf16_matches_plain(dev, B, T, H, W, k, C):
    """K4-bf16's float32 dW and db (bf16 x, weights and cotangent) within
    K4_TOL of its plain version's sums, once the cotangent of the near-tie
    windows (`convpool.near_ties`: the only ones another order of the
    float32 pre-activation sums can route elsewhere) is zero; a repeat gives
    the same bits; the model's Function rounds dW to bf16 once."""
    g = _gen(22)
    x = torch.rand(B, T, H, W, 1, generator=g).to(dev).to(torch.bfloat16)
    w = (torch.rand(*k, 1, C, generator=g) - 0.5).to(dev).to(torch.bfloat16)
    b = (torch.rand(C, generator=g) - 0.5).to(dev)
    cot = torch.randn(B, T, H // 2, W // 2, C, generator=g).to(dev).to(torch.bfloat16)
    ties = convpool.near_ties(x, w, b)
    print(f"K4-bf16 B={B} {H}x{W} C={C}: {int(ties.sum())} near-tie windows zeroed")
    cot = cot.masked_fill(ties, 0)
    want = convpool.conv1_pool_bwd_ref(x, w, b, cot)
    before = convpool.bwd_launches
    got = convpool.conv1_pool_bwd(x, w, b, cot)
    again = convpool.conv1_pool_bwd(x, w, b, cot)
    torch.cuda.synchronize()
    assert convpool.bwd_launches == before + 2
    for a, r, c in zip(got, want, again):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, r, **K4_TOL)
        assert torch.equal(a, c)
    wt = w.permute(4, 3, 0, 1, 2).contiguous().float().requires_grad_()
    convpool.conv1_pool_block(x.permute(0, 4, 1, 2, 3), wt, b).backward(
        cot.permute(0, 4, 1, 2, 3))
    assert torch.equal(wt.grad, got[0].permute(4, 3, 0, 1, 2).to(torch.bfloat16).float())


@pytest.mark.parametrize("B,T", [(1, 8), (8, 75), (128, 75)])
def test_conv1_pool_bwd_bf16_on_exact_grids(dev, B, T):
    """On exact-grid inputs the pre-activations are exact in any order, so
    K4-bf16 routes as its plain version: at B=1, T=8 on a full 50x100 frame
    the dW and db sums stay below 2^14 on a 2^-7 grid and are exact, equal
    bit for bit; at B = 8 and 128 within K4_TOL."""
    x, w, b, cot = _exact_grid(_gen(23), B, T, 50, 100, (3, 5, 5), 32, dev)
    got = convpool.conv1_pool_bwd(x, w, b, cot)
    want = convpool.conv1_pool_bwd_ref(x, w, b, cot)
    torch.cuda.synchronize()
    for a, r in zip(got, want):
        if B == 1:
            assert torch.equal(a, r)
        else:
            torch.testing.assert_close(a, r, **K4_TOL)


def test_bf16_lipnet_forward_and_backward_launch_k1_to_k4(dev):
    """Full-width LipNet under bf16 compute, both kernel flags: one K1-bf16
    and one K4-bf16 launch, two K2 and two K3 launches per step, finite
    float32 gradients, and log-probs within the JAX package's reduced-
    precision bounds of the float32 model's (mean |d| < 0.05, argmax
    agreement >= 0.95, tests/test_quant.py:135-137)."""
    from avsync_torch.config import ModelConfig
    from avsync_torch.models import LipNet
    from avsync_torch.ops.conv import fp32_step
    from avsync_torch.ops.ctc import ctc_loss_mean

    bf16 = LipNet(ModelConfig(use_pallas_gru=True, fused_conv_pool=True, dropout_rate=0.0,
                              compute_dtype="bfloat16"), generator=_gen(23)).to(dev)
    f32 = LipNet(ModelConfig(use_pallas_gru=True, fused_conv_pool=True, dropout_rate=0.0),
                 generator=_gen(24)).to(dev)
    f32.load_state_dict(bf16.state_dict())
    g = _gen(25)
    x = torch.rand(2, 75, 50, 100, 1, generator=g).to(dev)
    labels = torch.randint(1, 38, (2, 20), generator=g).to(dev)
    counts = (convpool.launches, convpool.bwd_launches, gru.launches, gru.bwd_launches)
    with fp32_step():
        lp = bf16(x)
        ctc_loss_mean(lp, labels, torch.tensor([20, 13])).backward()
        with torch.no_grad():
            ref = f32(x)
    torch.cuda.synchronize()
    after = (convpool.launches, convpool.bwd_launches, gru.launches, gru.bwd_launches)
    assert tuple(a - b for a, b in zip(after, counts)) == (2, 1, 4, 2)  # f32 K1 + K2 x2
    for name, p in bf16.named_parameters():
        assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), name
    assert (lp.detach() - ref).abs().mean().item() < 0.05
    assert (lp.argmax(-1) == ref.argmax(-1)).float().mean().item() >= 0.95


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


@pytest.mark.parametrize("B,T,H,reverse", [(8, 25, 256, False), (8, 25, 256, True),
                                             (3, 9, 20, False), (12, 5, 264, False)])
def test_gru_initial_state_matches_plain(dev, B, T, H, reverse):
    """K2 from a given h0 against the plain recurrence from the same h0
    (through the padding at H = 20 and the generic kernel at H = 264); K2
    with no h0 equal to K2 with h0 = zeros bit for bit."""
    g = _gen(7)
    gi = (torch.randn(B, T, 3 * H, generator=g)).to(dev)
    w = (torch.randn(H, 3 * H, generator=g) * 0.1).to(dev)
    b = (torch.randn(3 * H, generator=g) * 0.1).to(dev)
    h0 = torch.tanh(torch.randn(B, H, generator=g)).to(dev)
    got = gru.gru_recurrence(gi, w, b, reverse, h0=h0)
    want = gru.gru_recurrence_ref(gi, w, b, reverse, h0=h0)
    torch.testing.assert_close(got, want, **K2_TOL)
    none = gru.gru_recurrence(gi, w, b, reverse)
    assert torch.equal(none, gru.gru_recurrence(gi, w, b, reverse, h0=torch.zeros_like(h0)))


def test_gru_chunks_from_handed_off_states_equal_the_whole_chain(dev):
    """The context-parallel chain's invariant on the card: 75 steps as three
    chunks of 25, each from the last state of the one before, equal K2 over
    the whole sequence bit for bit."""
    g = _gen(8)
    B, T, H = 8, 75, 256
    gi = torch.randn(B, T, 3 * H, generator=g).to(dev)
    w = (torch.randn(H, 3 * H, generator=g) * 0.05).to(dev)
    b = (torch.randn(3 * H, generator=g) * 0.1).to(dev)
    whole = gru.gru_recurrence(gi, w, b)
    h, parts = None, []
    for c in range(3):
        parts.append(gru.gru_recurrence(gi[:, 25 * c:25 * (c + 1)].contiguous(), w, b, h0=h))
        h = parts[-1][:, -1]
    assert torch.equal(torch.cat(parts, dim=1), whole)


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


@pytest.mark.parametrize("B,T,H", [(8, 75, 256), (4, 38, 256), (1, 1, 256), (3, 7, 264),
                                   (3, 8, 20), (2, 5, 512)])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_bwd_from_h0_matches_plain(dev, B, T, H, reverse):
    """K3 from an initial state h0 with its gradient dh0 (a chunk of the
    context-parallel chain) within K3_TOL / K3_SUM_TOL of the plain version;
    with h0 = zeros and no dh0 it is the launch without h0, bit for bit."""
    g = _gen(12)
    gi, w, b = _gru_bwd_case(g, dev, B, T, H)
    h0 = torch.randn(B, H, generator=g).to(dev)
    out = gru.gru_recurrence_ref(gi, w, b, reverse, h0=h0)
    cot = torch.randn(B, T, H, generator=g).to(dev)
    want = gru.gru_recurrence_bwd_ref(gi, out, cot, w, b, reverse, h0=h0)
    before = gru.bwd_h0_launches
    got = gru.gru_recurrence_bwd(gi, out, cot, w, b, reverse, h0=h0)
    torch.cuda.synchronize()
    assert gru.bwd_h0_launches == before + 1
    torch.testing.assert_close(got[0], want[0], **K3_TOL)
    torch.testing.assert_close(got[3], want[3], **K3_TOL)
    for a, e in zip(got[1:3], want[1:3]):
        torch.testing.assert_close(a, e, **K3_SUM_TOL)
    plain = gru.gru_recurrence_bwd(gi, out, cot, w, b, reverse)
    zeros = gru.gru_recurrence_bwd(gi, out, cot, w, b, reverse, h0=torch.zeros_like(h0))
    for a, e in zip(plain, zeros):
        assert torch.equal(a, e)


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


# the TF stack's conv1 (Cin 1, 128 channels, 3x3x3 at 46 x 140: a 7 x 35 tile,
# four channel groups in K4), and a ragged one (25 x 69 pooled, 100 channels:
# dead rows and columns, a last group of 4 channels)
TF_CONV1 = [(2, 8, 46, 140, 128), (2, 5, 50, 138, 100)]


@pytest.mark.parametrize("B,T,H,W,C", TF_CONV1, ids=["tf", "ragged"])
def test_conv1_pool_at_the_tf_width_equals_plain_bit_for_bit(dev, B, T, H, W, C):
    """K1 at 128 channels runs each channel's fmaf chain as the plain
    version does: equal bits in both layouts, and a repeat launch too."""
    g = _gen(21)
    x = torch.randn(B, T, H, W, 1, generator=g).to(dev)
    w = ((torch.rand(3, 3, 3, 1, C, generator=g) * 2 - 1) / 27 ** 0.5).to(dev)
    b = ((torch.rand(C, generator=g) * 2 - 1) / 27 ** 0.5).to(dev)
    want = convpool.conv1_pool_ref(x, w, b)
    got = convpool.conv1_pool_fused(x, w, b)
    got_n = convpool.conv1_pool_block(x.permute(0, 4, 1, 2, 3),
                                      w.permute(4, 3, 0, 1, 2).contiguous(), b)
    assert torch.equal(got, want)
    assert torch.equal(got_n, want.permute(0, 4, 1, 2, 3))
    assert torch.equal(got, convpool.conv1_pool_fused(x, w, b))


@pytest.mark.parametrize("B,T,H,W,C", TF_CONV1, ids=["tf", "ragged"])
def test_conv1_pool_bwd_at_the_tf_width_matches_plain(dev, B, T, H, W, C):
    """K4 over channel groups: dW and db within K4_TOL of the plain version
    in both layouts, one launch per call, and a repeat launch gives the same
    bits (the groups write their own columns of each partial row; no float
    atomics)."""
    g = _gen(22)
    x = torch.randn(B, T, H, W, 1, generator=g).to(dev)
    w = ((torch.rand(3, 3, 3, 1, C, generator=g) * 2 - 1) / 27 ** 0.5).to(dev)
    b = ((torch.rand(C, generator=g) * 2 - 1) / 27 ** 0.5).to(dev)
    cot = torch.randn(B, T, H // 2, W // 2, C, generator=g).to(dev)
    want = convpool.conv1_pool_bwd_ref(x, w, b, cot)
    before = convpool.bwd_launches
    got = convpool.conv1_pool_bwd(x, w, b, cot)
    got_n = convpool.conv1_pool_block_bwd(x.permute(0, 4, 1, 2, 3),
                                          w.permute(4, 3, 0, 1, 2).contiguous(), b,
                                          cot.permute(0, 4, 1, 2, 3))
    again = convpool.conv1_pool_bwd(x, w, b, cot)
    torch.cuda.synchronize()
    assert convpool.bwd_launches == before + 3
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, **K4_TOL)
    torch.testing.assert_close(got_n[0], want[0].permute(4, 3, 0, 1, 2), **K4_TOL)
    torch.testing.assert_close(got_n[1], want[1], **K4_TOL)
    for a, r in zip(got, again):
        assert torch.equal(a, r)


def _tf_trainer_and_plan(dev, S=4, B=2, N=8, T=8):
    import numpy as np

    from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig, TrainConfig
    from avsync_torch.train.lipnet_trainer import LipNetTrainer
    from avsync_torch.utils.logging import Logger

    cfg = AvsyncConfig(
        data=DataConfig(img_height=46, img_width=140, max_video_length=T, batch_size=B,
                        max_label_length=4, standardize_clips=True),
        model=ModelConfig(family="tf", hidden_dim=16, fused_conv_pool=True),
        train=TrainConfig(learning_rate=1e-3, seed=7))
    g = _gen(23)
    video = torch.randn(N, T, 46, 140, 1, generator=g).to(dev)
    labels = torch.randint(1, 27, (N, 4), generator=g).to(dev)
    plan = {"video": video, "gather": lambda row: video.index_select(0, row), "labels": labels,
            "lengths": torch.full((N,), 4, device=dev),
            "idx": np.arange(S * B).reshape(S, B) % N}
    trainer = LipNetTrainer(cfg, device=dev, log=Logger(None, console=False))
    return trainer, trainer.init_state(), plan


def test_tf_captured_step_launches_k1_and_k4_once_per_step(dev):
    """The TF stack with `fused_conv_pool` in an epoch program: the wrapper
    counters see one K1 and one K4 launch per eager warm-up step and one of
    each in the capture; the replays launch nothing through the wrappers
    and run, per step, K1 and K4 (its main kernel) once and the pool's
    forward only for conv2 and conv3 (no cuDNN conv1, no separate ReLU or
    pool for it); two runs from the same weights give the same bits."""
    from torch.profiler import ProfilerActivity, profile

    from avsync_torch.train.epoch_program import WARMUP_STEPS

    trainer, state, plan = _tf_trainer_and_plan(dev)
    assert state.model.conv1.fused
    k1, k4 = convpool.launches, convpool.bwd_launches
    trainer.train_epoch_scanned(state, plan)
    torch.cuda.synchronize()
    assert (convpool.launches - k1, convpool.bwd_launches - k4) == (WARMUP_STEPS + 1,) * 2
    k1, k4 = convpool.launches, convpool.bwd_launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_epoch_scanned(state, plan)
        torch.cuda.synchronize()
    assert (convpool.launches, convpool.bwd_launches) == (k1, k4)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    S = len(plan["idx"])
    assert sum("conv1_pool_kernel<" in n for n in names) == S
    assert sum("conv1_pool_bwd_kernel<" in n for n in names) == S
    pools = sum("max_pool3d_with_indices" in n and "backward" not in n for n in names)
    assert pools == 2 * S, pools
    again, state2, _ = _tf_trainer_and_plan(dev)
    again.train_epoch_scanned(state2, plan)
    again.train_epoch_scanned(state2, plan)
    torch.cuda.synchronize()
    for (n, p), q in zip(state.model.named_parameters(), state2.model.parameters()):
        assert torch.equal(p, q), n


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
    from avsync_torch.ops.conv import fp32_step

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


# ---------------------------------------------------------------------------
# under CUDA-graph capture (the trainers' epoch programs replay them)
# ---------------------------------------------------------------------------

def _graph_case(name, dev, seed):
    """(wrapper, inputs) at the main paths' shapes: K1-K4 at B=8, T=75 of
    the LipNet step, K5 at a detector step's B=32, F=121."""
    g = _gen(seed)
    B, T, H = 8, 75, 256
    if name in ("conv1_pool", "conv1_pool_bwd"):
        x = torch.rand(B, T, 50, 100, 1, generator=g)
        k = torch.randn(3, 5, 5, 1, 32, generator=g) * 0.2
        b = torch.randn(32, generator=g) * 0.1
        if name == "conv1_pool":
            return convpool.conv1_pool_fused, [t.to(dev) for t in (x, k, b)]
        cot = torch.randn(B, T, 25, 50, 32, generator=g)
        return convpool.conv1_pool_bwd, [t.to(dev) for t in (x, k, b, cot)]
    if name in ("gru_fwd", "gru_bwd"):
        gi = [torch.randn(B, T, 3 * H, generator=g) for _ in range(2)]
        w = [torch.randn(H, 3 * H, generator=g) / H ** 0.5 for _ in range(2)]
        bh = [torch.randn(3 * H, generator=g) * 0.1 for _ in range(2)]
        args = [t.to(dev) for t in (*gi, *w, *bh)]
        if name == "gru_fwd":
            return gru.bigru_recurrence, args
        out = gru.bigru_recurrence(*args)
        cot = torch.randn(B, T, 2 * H, generator=g).to(dev)
        return gru.bigru_recurrence_bwd, [args[0], args[1], out, cot, *args[2:]]
    power, n, melT, dctT = _mel_case(g, dev, 32, 121, 16000, 2048, 128, 20, False)
    return mfcc.mel_stats, [power, n, melT, dctT]


@pytest.mark.parametrize("name", ["conv1_pool", "gru_fwd", "gru_bwd", "conv1_pool_bwd",
                                  "mel_stats"])
def test_wrapper_replayed_from_a_cuda_graph_equals_eager(dev, name):
    """Each wrapper captured once (after a warm-up launch on the capture
    stream), then replayed on two sets of inputs copied into the captured
    ones: the same bits as an eager launch on those inputs. A replay passes
    through no wrapper, so the launch counter sees the eager calls only."""
    fn, static = _graph_case(name, dev, 30)
    if name == "mel_stats":
        later = [_graph_case(name, dev, s)[1] for s in (31, 32)]
        for case in later:
            case[2], case[3] = static[2], static[3]  # one filterbank, as audio_stats
    else:
        later = [_graph_case(name, dev, s)[1] for s in (31, 32)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn(*static)
    captured = captured if isinstance(captured, tuple) else (captured,)
    counter = {"conv1_pool": "launches", "gru_fwd": "launches", "gru_bwd": "bwd_launches",
               "conv1_pool_bwd": "bwd_launches", "mel_stats": "launches"}[name]
    module = {"conv1_pool": convpool, "conv1_pool_bwd": convpool, "gru_fwd": gru,
              "gru_bwd": gru, "mel_stats": mfcc}[name]
    for inputs in later:
        for s, x in zip(static, inputs):
            if s is not x:  # a self-copy would bump melT's version and rebuild its band table
                s.copy_(x)
        before = getattr(module, counter)
        graph.replay()
        torch.cuda.synchronize()
        assert getattr(module, counter) == before
        want = fn(*inputs)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        for got, ref in zip(captured, want):
            assert torch.equal(got, ref)


# ---------------------------------------------------------------------------
# the kernel operators (the model calls them; torch.export traces them)
# ---------------------------------------------------------------------------

def _operator_case(name, dev, seed):
    """(operator, direct CUDA body, module, inputs) at the serving paths'
    shapes: K1 at B=8, T=75 (NCDHW), K2 at B=8, T=75, H=256 with torch-layout
    w_hh views, K5 at a scorer batch of 8 requests x 5 shifts."""
    g = _gen(seed)
    if name == "conv1_pool":
        args = (torch.rand(8, 1, 75, 50, 100, generator=g),
                torch.randn(32, 1, 3, 5, 5, generator=g) * 0.2, torch.randn(32, generator=g))
        return (torch.ops.avsync_torch.conv1_pool, convpool._conv1_pool_cuda, convpool,
                [t.to(dev) for t in args])
    if name == "bigru_fwd":
        H = 256
        gi = [torch.randn(8, 75, 3 * H, generator=g) for _ in range(2)]
        w = [(torch.randn(3 * H, H, generator=g) / H ** 0.5).to(dev).t() for _ in range(2)]
        b = [torch.randn(3 * H, generator=g) * 0.1 for _ in range(2)]
        return (torch.ops.avsync_torch.bigru_fwd, gru._bigru_fwd_cuda, gru,
                [gi[0].to(dev), gi[1].to(dev), *w, b[0].to(dev), b[1].to(dev)])
    power, n, melT, dctT = _mel_case(g, dev, 40, 121, 16000, 2048, 128, 20, False)
    return (torch.ops.avsync_torch.mel_stats, mfcc._mel_stats_cuda, mfcc,
            [power, n, melT, dctT, 80.0])


@pytest.mark.parametrize("name", ["conv1_pool", "bigru_fwd", "mel_stats"])
def test_operator_equals_the_direct_launch_eager_and_replayed(dev, name):
    """Each operator on the card launches its kernel once (the counter says
    so) and equals the direct launch bit for bit; captured in a CUDA graph
    and replayed on new inputs it equals a direct launch on those."""
    op, direct, module, static = _operator_case(name, dev, 40)
    before = module.launches
    got, want = op(*static), direct(*static)
    torch.cuda.synchronize()
    assert module.launches == before + 2
    assert torch.equal(got, want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        op(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = op(*static)
    for seed in (41, 42):
        inputs = _operator_case(name, dev, seed)[3]
        if name == "mel_stats":
            inputs[2], inputs[3] = static[2], static[3]  # one filterbank, as audio_stats
        for s, x in zip(static, inputs):
            if torch.is_tensor(s) and s is not x:  # a self-copy would bump melT's version
                s.copy_(x)
        graph.replay()
        want = direct(*inputs)
        torch.cuda.synchronize()
        assert torch.equal(captured, want)


def test_exported_programs_launch_the_kernels(dev, tmp_path):
    """A transcriber and a sync-scorer artifact exported on the card: a
    profiler trace of one call of each names K1 and K2, and K1 and K5."""
    from avsync_torch.compat import save_detector_pth, save_lipnet_pth
    from avsync_torch.config import AudioConfig, AvsyncConfig, ModelConfig
    from avsync_torch.export import export_sync_scorer, export_transcriber, load_exported
    from avsync_torch.models import LipNet, MisalignmentDetector

    cfg = AvsyncConfig(model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True),
                       audio=AudioConfig(use_pallas=True))
    lip, det = str(tmp_path / "lip.pth"), str(tmp_path / "det.pth")
    save_lipnet_pth(LipNet(cfg.model, generator=_gen(50)).state_dict(), lip)
    save_detector_pth(MisalignmentDetector(generator=_gen(51)).state_dict(), det, 13864, 256, {})
    export_transcriber(lip, cfg, device=dev, batch_sizes=(2,)).save(str(tmp_path / "t.zip"))
    export_sync_scorer(det, lip, cfg, num_shifts=3, device=dev).save(str(tmp_path / "s.zip"))
    transcriber, scorer = (load_exported(str(tmp_path / n)) for n in ("t.zip", "s.zip"))
    g = torch.Generator().manual_seed(52)
    frames = torch.randint(0, 256, (2, 75, 50, 100), generator=g, dtype=torch.uint8).numpy()
    audio = (torch.rand(2, 48000, generator=g) - 0.5).numpy()
    calls = {"transcriber": (lambda: transcriber.call(frames), ("conv1_pool_kernel",
                                                                 "gru_fwd_kernel")),
             "sync_scorer": (lambda: scorer.call(frames, audio, [48000, 30000], [25.0, 25.0],
                                                 [[-5, 0, 5]] * 2),
                             ("conv1_pool_kernel", "mel_stats_kernel"))}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for kind, (call, kernels) in calls.items():
        call()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            call()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        for k in kernels:
            assert any(k in n for n in names), (kind, k, sorted(names))


# ---------------------------------------------------------------------------
# Q1: the int8 conv + dequant + ReLU + pool block of int8 serving
# ---------------------------------------------------------------------------

def q1_case(g, dev, B, cin, cout, T, H, W, k, mode="random"):
    """(QuantConvParams, x) on the card. 'random': x around 0.3 with negative
    values, random int8 weights and per-channel scales, x_scale = absmax/127;
    'ties': x_scale 0.5 and x in quarters, so x / x_scale hits exact halves
    (round half to even) and the clip; 'near_ties': x_scale 1/3 and x at
    (k + 0.5) * x_scale, so x / x_scale falls within an ulp or two of a half
    (the quantizer's exact fallback); 'extreme': every x at +127 steps and
    every weight 127, the largest |acc| the block can reach."""
    from avsync_torch.ops.quant import quant_conv_params

    kq = torch.randint(-127, 128, (cout, cin, *k), generator=g, dtype=torch.int8)
    ks = torch.rand(cout, generator=g) * 0.01 + 1e-4
    bias = torch.randn(cout, generator=g) * 0.1
    if mode == "ties":
        x = torch.randint(-300, 301, (B, cin, T, H, W), generator=g).float() / 4
        xs = 0.5
    elif mode == "near_ties":  # x / x_scale within an ulp or two of k + 0.5
        xs = float(torch.tensor(1 / 3))
        x = (torch.randint(-130, 130, (B, cin, T, H, W), generator=g) + 0.5).float() * xs
    elif mode == "extreme":
        kq.fill_(127)
        xs = 0.01
        x = torch.full((B, cin, T, H, W), 127 * xs)
    else:
        x = torch.randn(B, cin, T, H, W, generator=g) * 0.5 + 0.3
        xs = float(x.abs().max()) / 127
    return quant_conv_params(kq.to(dev), ks, bias, xs), x.to(dev)


def q1_ref(qc, x, out_scale=None, dt=None):
    return quantconv.int8_conv_pool_ref(x, qc.kernel_q, qc.k_scale, qc.bias, float(qc.x_scale),
                                        out_scale, compute_dtype=dt)


# (B, Cin, Cout, T, H, W, kernel, mode): LipNet's three blocks at full width
# (B = 1, 8 and 32: the frames per CTA differ), then the odd ones: byte
# gathers (Cin 1, 3), Cin % 4 == 0 but not % 16, Cout past a 32-channel
# group, odd H or W (floor pools), a pooled row wider than any tile, a kernel
# of one frame, fewer frames than the kernel's (T < kt), exact-half ties and
# the largest accumulators
Q1_CASES = [
    (1, 1, 32, 75, 50, 100, (3, 5, 5), "random"), (8, 1, 32, 75, 50, 100, (3, 5, 5), "random"),
    (1, 32, 64, 75, 25, 50, (3, 5, 5), "random"), (8, 32, 64, 75, 25, 50, (3, 5, 5), "random"),
    (1, 64, 96, 75, 12, 25, (3, 3, 3), "random"), (8, 64, 96, 75, 12, 25, (3, 3, 3), "random"),
    (32, 32, 64, 75, 25, 50, (3, 5, 5), "random"), (32, 64, 96, 75, 12, 25, (3, 3, 3), "random"),
    (2, 3, 5, 5, 9, 13, (1, 3, 5), "random"), (3, 64, 40, 4, 13, 27, (3, 3, 3), "random"),
    (2, 1, 7, 3, 7, 201, (5, 1, 3), "random"), (2, 12, 33, 2, 6, 10, (3, 5, 5), "random"),
    (2, 32, 64, 2, 25, 50, (3, 5, 5), "random"), (1, 16, 24, 1, 10, 14, (3, 3, 3), "random"),
    (2, 48, 20, 6, 11, 17, (3, 3, 3), "random"),
    (2, 32, 64, 3, 25, 50, (3, 5, 5), "ties"), (1, 32, 64, 3, 25, 50, (3, 5, 5), "extreme"),
    (1, 1, 32, 3, 50, 100, (3, 5, 5), "ties"), (2, 32, 64, 3, 25, 50, (3, 5, 5), "near_ties"),
    (1, 1, 32, 3, 50, 100, (3, 5, 5), "near_ties"),
]
# (input dtype, output dtype) of the operator's contracts: the f32
# epilogue's, then the bf16 epilogue's (`dt` bf16)
CONTRACTS = ["f32_f32", "f32_s8", "s8_s8", "s8_f32"]
BF16_CONTRACTS = ["f32_bf16", "f32_s8", "s8_s8", "s8_bf16"]


def channels_last(x):
    return x.permute(0, 2, 3, 4, 1).contiguous().permute(0, 4, 1, 2, 3)


def q1_contract(qc, x, contract, mode, dt=None):
    """(input, out_scale) of one contract: an int8 input is x quantized with
    the block's scale, channels-last (as a block writes it); an int8 output
    takes a scale that maps the float output's largest value (bf16 under
    `dt` bf16) to 127 (to 200 in 'extreme' mode: past the clip), or 0.125
    in 'ties' mode."""
    if contract.startswith("s8"):
        x = channels_last(quantconv.quantize_input(x, float(qc.x_scale)).to(torch.int8))
    if not contract.endswith("s8"):
        return x, None
    top = float(q1_ref(qc, x, dt=dt).float().max())
    return x, {"ties": 0.125, "extreme": top / 200}.get(mode, top / 127 or 1.0)


@pytest.mark.parametrize("dt,contract",
                         [pytest.param(None, c, id=c) for c in CONTRACTS]
                         + [pytest.param(torch.bfloat16, c, id="bf16-" + c)
                            for c in BF16_CONTRACTS])
@pytest.mark.parametrize("B,cin,cout,T,H,W,k,mode", Q1_CASES)
def test_int8_conv_pool_equals_plain_bit_for_bit(dev, B, cin, cout, T, H, W, k, mode, dt,
                                                 contract):
    """Q1 equals its plain version bit for bit in each contract (exact int32
    sums, the same two f32 roundings, the same quantizer; under `dt` bf16
    the bf16 epilogue's three bf16 roundings); a repeat launch gives the
    same bits and moves only its epilogue's counter; other layouts of the
    input give the same bits: channels-last and sliced f32, an int8 input at
    an address that is not 16-byte aligned (the byte-wise staging)."""
    from avsync_torch.ops.quant import quant_conv_block

    qc, x = q1_case(_gen(60), dev, B, cin, cout, T, H, W, k, mode)
    x, out_scale = q1_contract(qc, x, contract, mode, dt)
    before = (quantconv.launches, quantconv.bf16_launches)
    got = quant_conv_block(qc, x, out_scale, compute_dtype=dt)
    again = quant_conv_block(qc, x, out_scale, compute_dtype=dt)
    torch.cuda.synchronize()
    assert (quantconv.launches, quantconv.bf16_launches) == (
        (before[0] + 2, before[1]) if dt is None else (before[0], before[1] + 2))
    want = q1_ref(qc, x, out_scale, dt)
    assert got.shape == want.shape == (B, cout, T, H // 2, W // 2)
    assert got.dtype == want.dtype == (torch.int8 if out_scale is not None
                                       else dt or torch.float32)
    assert got.permute(0, 2, 3, 4, 1).is_contiguous()
    assert torch.equal(got, want) and torch.equal(got, again)
    if x.dtype == torch.float32:
        assert torch.equal(quant_conv_block(qc, channels_last(x), out_scale, compute_dtype=dt),
                           got)
        wide = torch.zeros(B, cin, T, H, W + 3, device=dev)
        wide[..., :W] = x
        assert torch.equal(quant_conv_block(qc, wide[..., :W], out_scale, compute_dtype=dt),
                           got)
    else:
        flat = torch.empty(x.numel() + 1, dtype=torch.int8, device=dev)[1:]
        odd = flat.view(B, T, H, W, cin).permute(0, 4, 1, 2, 3)
        odd.copy_(x)
        assert torch.equal(quant_conv_block(qc, odd, out_scale, compute_dtype=dt), got)


@pytest.mark.parametrize("frames", [1, 2, 4, 7, 8, 13, 74, 75, 200])
def test_int8_conv_pool_frames_per_cta_change_no_bit(dev, frames, monkeypatch):
    """Whatever the frames per CTA (runs that end past T, one run of the
    whole clip, more frames than the clip has), the same bits in the
    int8-in, int8-out contract of LipNet's conv2 and the f32-in of conv1."""
    from avsync_torch.ops.quant import quant_conv_block

    monkeypatch.setattr(quantconv, "frames_for", lambda *args: frames)
    for i, (B, cin, cout, T, H, W, k) in enumerate([(2, 32, 64, 75, 25, 50, (3, 5, 5)),
                                                    (2, 1, 32, 75, 50, 100, (3, 5, 5))]):
        qc, x = q1_case(_gen(70 + i), dev, B, cin, cout, T, H, W, k)
        x, out_scale = q1_contract(qc, x, "s8_s8" if cin > 1 else "f32_s8", "random")
        assert torch.equal(quant_conv_block(qc, x, out_scale), q1_ref(qc, x, out_scale))


def test_int8_conv_pool_shared_memory_mirrors_the_kernel(dev):
    """The wrapper's `shared_memory_bytes` (the offset tables, the ring of
    kt + 1 frames and the B ring's two stages of `chunks` k-chunks x
    `groups` channel groups) is the kernel's `smem_bytes`, which the launch
    asks for."""
    fn = build.function("int8_conv_pool", "avs_int8_conv_pool_smem", quantconv._SMEM_ARGTYPES)
    for cin, k in [(1, (3, 5, 5)), (32, (3, 5, 5)), (64, (3, 3, 3)), (3, (1, 3, 5)),
                   (12, (3, 5, 5)), (128, (3, 3, 3)), (256, (3, 3, 3))]:
        kpad = quantconv.padded(cin * k[0] * k[1] * k[2])
        rings = [(1, 2), (2, 4), (4, 8), (8, 16)] if cin % 16 == 0 else [(0, 0)]
        for rows, cols in [(1, 1), (5, 25), (12, 5), (6, 12), (6, 4), (3, 7), (11, 5), (5, 6)]:
            for ring in rings:
                assert fn(cin, kpad, *k, rows, cols, quantconv.pos_bytes(cin), *ring) == \
                    quantconv.shared_memory_bytes(cin, kpad, *k, rows, cols, *ring)


# the TF-family LipNet's three blocks at its full width (75 x 46 x 140 crops,
# 3x3x3 kernels): (Cin, Cout, H, W); Kpad 3,456 and 6,912 for conv2 and conv3
TF_Q1_BLOCKS = [(1, 128, 46, 140), (128, 256, 23, 70), (256, 64, 11, 35)]


@pytest.mark.parametrize("contract", CONTRACTS)
@pytest.mark.parametrize("cin,cout,H,W", TF_Q1_BLOCKS, ids=["conv1", "conv2", "conv3"])
def test_int8_conv_pool_equals_plain_at_the_tf_blocks(dev, cin, cout, H, W, contract):
    """Q1 at the TF stack's blocks (B=2, conv2/conv3 inputs channels-last as
    the int8 forward gives them) equals its plain version bit for bit, a
    repeat launch too, and the launch's shared memory is the wrapper's."""
    from avsync_torch.ops.quant import quant_conv_block

    qc, x = q1_case(_gen(80), dev, 2, cin, cout, 75, H, W, (3, 3, 3))
    if cin > 1:
        x = channels_last(x)
    x, out_scale = q1_contract(qc, x, contract, "random")
    got = quant_conv_block(qc, x, out_scale)
    again = quant_conv_block(qc, x, out_scale)
    want = q1_ref(qc, x, out_scale)
    assert got.shape == want.shape == (2, cout, 75, H // 2, W // 2) and got.dtype == want.dtype
    assert torch.equal(got, want) and torch.equal(got, again)
    fn = build.function("int8_conv_pool", "avs_int8_conv_pool_smem", quantconv._SMEM_ARGTYPES)
    tile = quantconv.tile_for(H // 2, W // 2, cin, cout, 3, 3, 3)
    kpad = quantconv.padded(cin * 27)
    assert fn(cin, kpad, 3, 3, 3, tile.rows, tile.cols, quantconv.pos_bytes(cin),
              *tile[2:]) == quantconv.shared_memory_bytes(cin, kpad, 3, 3, 3, *tile)


@pytest.mark.parametrize("contract", ["s8_s8", "f32_f32"])
@pytest.mark.parametrize("cin,cout,H,W", TF_Q1_BLOCKS, ids=["conv1", "conv2", "conv3"])
def test_int8_conv_pool_every_tile_the_planner_may_return(dev, cin, cout, H, W, contract,
                                                           monkeypatch):
    """Q1 at the TF stack's blocks (B=1, T=3) equals its plain version bit
    for bit at every tile the planner chooses from (`tiles_to_try`: each
    tile, and each channel-group count and stage size of the B ring that
    fits), forced by monkeypatching `tile_for`."""
    from avsync_torch.ops.quant import quant_conv_block

    qc, x = q1_case(_gen(81), dev, 1, cin, cout, 3, H, W, (3, 3, 3))
    x, out_scale = q1_contract(qc, channels_last(x) if cin > 1 else x, contract, "random")
    want = q1_ref(qc, x, out_scale)
    tiles = list(quantconv.tiles_to_try(H // 2, W // 2, cin, cout, 3, 3, 3))
    assert quantconv.tile_for(H // 2, W // 2, cin, cout, 3, 3, 3) in tiles
    for tile in tiles:
        monkeypatch.setattr(quantconv, "tile_for", lambda *args, tile=tile: tile)
        assert torch.equal(quant_conv_block(qc, x, out_scale), want), tile


def calibrated_chain(g, dev, x):
    """LipNet's three int8 blocks with random weights, each block's input
    scale its f32 input's absmax / 127 (as calibration sets it)."""
    from avsync_torch.ops.quant import quant_conv_block, quant_conv_params

    qcs = []
    for cin, cout, k in [(1, 32, (3, 5, 5)), (32, 64, (3, 5, 5)), (64, 96, (3, 3, 3))]:
        kq = torch.randint(-127, 128, (cout, cin, *k), generator=g, dtype=torch.int8)
        ks = torch.rand(cout, generator=g) * 0.01 + 1e-4
        qc = quant_conv_params(kq.to(dev), ks, torch.randn(cout, generator=g) * 0.1,
                               float(x.abs().max()) / 127)
        qcs.append(qc)
        x = quant_conv_block(qc, x)
    return qcs


def test_int8_conv_pool_replayed_from_a_cuda_graph_equals_eager(dev):
    """LipNet's three blocks with the int8 hand-off, captured once and
    replayed on new inputs copied into the captured one: the same bits as
    eager launches, and as three f32-contract launches; replays pass
    through no wrapper."""
    from avsync_torch.ops.quant import quant_conv_block

    static = torch.rand(8, 75, 50, 100, 1, generator=_gen(62)).to(dev).permute(0, 4, 1, 2, 3)
    qcs = calibrated_chain(_gen(61), dev, static)
    scales = [float(qc.x_scale) for qc in qcs[1:]] + [None]

    def chain(x, hand_off=True):
        for qc, s in zip(qcs, scales):
            x = quant_conv_block(qc, x, s if hand_off else None)
        return x

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = chain(static)
    for seed in (63, 64):
        static.copy_(torch.rand(static.shape, generator=_gen(seed)).to(dev))
        before = quantconv.launches
        graph.replay()
        torch.cuda.synchronize()
        assert quantconv.launches == before
        assert torch.equal(captured, chain(static))
        assert torch.equal(captured, chain(static, hand_off=False))


def test_int8_reader_launches_q1_and_k2_only_and_keeps_the_jax_bounds(dev, tmp_path):
    """A full-width int8 LipReader batch of 8 on the card: Q1 three times, K2
    twice, K1 never; its log-probs within the JAX package's bounds of the f32
    reader's (tests/test_quant.py:135-137)."""
    from avsync_torch.config import AvsyncConfig, ModelConfig
    from avsync_torch.models import LipNet
    from avsync_torch.predictor import LipReader

    cfg = AvsyncConfig(model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True))
    state = LipNet(cfg.model, generator=_gen(64)).state_dict()
    f32 = LipReader(params=state, config=cfg, device=dev)
    int8 = LipReader(params=state, config=cfg, device=dev, quantize="int8")
    frames = torch.randint(0, 256, (8, 75, 50, 100), generator=_gen(65), dtype=torch.uint8)
    clips = f32.preprocess_device(frames.numpy())
    int8._logprobs(clips)  # calibrates (K1 runs the f32 conv1) and builds Q1
    torch.cuda.synchronize()
    before = (quantconv.launches, gru.launches, convpool.launches)
    got = int8._logprobs(clips)
    torch.cuda.synchronize()
    assert (quantconv.launches - before[0], gru.launches - before[1],
            convpool.launches - before[2]) == (3, 2, 0)
    want = f32._logprobs(clips)
    assert (got - want).abs().mean().item() < 0.05
    assert (got.argmax(-1) == want.argmax(-1)).float().mean().item() >= 0.95


@pytest.mark.parametrize("B,T,H", [(8, 75, 256), (3, 75, 256), (32, 75, 256), (1, 1, 256),
                                   (9, 6, 40), (3, 7, 264), (5, 6, 512), (3, 8, 20)])
def test_gru_bf16_operands_match_plain(dev, B, T, H):
    """K2 with bf16 operands (the kernel's bf16 flag), at every rows-per-cluster
    choice, through the generic kernel and the padding: every step within
    K2_TOL of the plain version's step (`gru_recurrence_ref(compute_dtype=
    bf16)`) from the kernel's own previous state, both directions; a repeat
    gives the same bits; past the first step it differs from the float32
    kernel. Over a whole sequence K2_TOL is no bound: float32 sums in
    another order move h by an ulp, which can move bf16(h) by a bf16 ulp at
    a later step, and the plain version on the card and on the CPU part by
    ~3e-4 at B=8, T=75; there the kernel must be no farther from the plain
    version, in the mean, than a tenth of the bf16 rounding's own mean
    effect (or K2_TOL's atol where that effect is 0: h_0 = 0)."""
    bf = torch.bfloat16
    g = _gen(3)
    k = H ** -0.5
    args = []
    for _ in range(2):
        args.append((torch.randn(B, T, 3 * H, generator=g).to(dev),
                     ((torch.rand(H, 3 * H, generator=g) * 2 - 1) * k).to(dev),
                     ((torch.rand(3 * H, generator=g) * 2 - 1) * k).to(dev)))
    (gf, wf, bf_), (gb, wb, bb) = args
    before = (gru.bf16_launches, gru.launches)
    got = gru.bigru_recurrence_bf16(gf, gb, wf, wb, bf_, bb)
    again = gru.bigru_recurrence_bf16(gf, gb, wf, wb, bf_, bb)
    torch.cuda.synchronize()
    assert (gru.bf16_launches, gru.launches) == (before[0] + 2, before[1])
    torch.testing.assert_close(got, gru.bigru_steps_ref(gf, gb, wf, wb, bf_, bb, got, bf),
                               **K2_TOL)
    assert torch.equal(got, again)
    want = torch.cat([gru.gru_recurrence_ref(gf, wf, bf_, False, compute_dtype=bf),
                      gru.gru_recurrence_ref(gb, wb, bb, True, compute_dtype=bf)], -1)
    f32 = torch.cat([gru.gru_recurrence_ref(gf, wf, bf_, False),
                     gru.gru_recurrence_ref(gb, wb, bb, True)], -1)
    assert (got - want).abs().mean() <= max(0.1 * (want - f32).abs().mean(), K2_TOL["atol"])
    if T > 1:
        assert not torch.equal(got, gru.bigru_recurrence(gf, gb, wf, wb, bf_, bb))


@pytest.mark.parametrize("H,reverse", [(256, False), (256, True), (264, False)])
def test_gru_bf16_operands_from_an_initial_state(dev, H, reverse):
    """K2 with bf16 operands from a given h0 (the register kernel keeps each
    writer's f32 carry apart from the bf16 h it pushes; the generic kernel
    at H = 264 rounds as it reads): every step within K2_TOL of the plain
    version's step from the kernel's previous state, the first from h0."""
    g = _gen(4)
    B, T = 3, 9
    k = H ** -0.5
    gi = torch.randn(B, T, 3 * H, generator=g).to(dev)
    w = ((torch.rand(H, 3 * H, generator=g) * 2 - 1) * k).to(dev)
    b = ((torch.rand(3 * H, generator=g) * 2 - 1) * k).to(dev)
    h0 = torch.randn(B, H, generator=g).to(dev) * 0.5
    got = gru._launch((gi,), (w,), (b,), int(reverse), (h0,), bf16=True)
    order = range(T - 1, -1, -1) if reverse else range(T)
    prev = h0
    for t in order:
        step = gru.gru_recurrence_ref(gi[:, t:t + 1], w, b, h0=prev,
                                      compute_dtype=torch.bfloat16)[:, 0]
        torch.testing.assert_close(got[:, t], step, **K2_TOL)
        prev = got[:, t]


def test_int8_bf16_reader_launches_q1_bf16_and_k2_bf16_only(dev):
    """A full-width int8 LipReader batch of 8 under bf16 compute: Q1's bf16
    epilogue three times, K2 with bf16 operands twice, no other hand
    kernel; its log-probs within the JAX package's int8 bounds of the bf16
    float reader's (tests/test_quant.py:135-137)."""
    from avsync_torch.config import AvsyncConfig, ModelConfig
    from avsync_torch.models import LipNet
    from avsync_torch.predictor import LipReader

    cfg = AvsyncConfig(model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True,
                                         compute_dtype="bfloat16"))
    state = LipNet(cfg.model, generator=_gen(66)).state_dict()
    b16 = LipReader(params=state, config=cfg, device=dev)
    int8 = LipReader(params=state, config=cfg, device=dev, quantize="int8")
    frames = torch.randint(0, 256, (8, 75, 50, 100), generator=_gen(67), dtype=torch.uint8)
    clips = b16.preprocess_device(frames.numpy())
    int8._logprobs(clips)  # calibrates in f32 (K1's f32 instantiation) and builds the kernels
    torch.cuda.synchronize()
    names = ("bf16_launches", "launches")
    before = ([getattr(quantconv, n) for n in names], [getattr(gru, n) for n in names],
              convpool.launches)
    got = int8._logprobs(clips)
    torch.cuda.synchronize()
    assert [getattr(quantconv, n) - b for n, b in zip(names, before[0])] == [3, 0]
    assert [getattr(gru, n) - b for n, b in zip(names, before[1])] == [2, 0]
    assert convpool.launches == before[2]
    want = b16._logprobs(clips)
    assert got.dtype == torch.float32
    assert (got - want).abs().mean().item() < 0.05
    assert (got.argmax(-1) == want.argmax(-1)).float().mean().item() >= 0.95


def test_roi_boxes_on_the_card_equal_the_cpu(dev):
    """The variance boxes of the same native frames are the same bits on the
    card as on the CPU, and the localizer's within 1e-5 with the same gate
    choice (the ROI code divides by device tensors: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal)."""
    import copy

    from avsync_torch.models import localizer
    from avsync_torch.ops.image import true_div, variance_mouth_boxes

    g = _gen(12)
    x = (torch.rand(4, 75, 288, 360, generator=g) * 255).round()
    x[:, :, 180:260, 120:240] += 60 * torch.rand(4, 75, 1, 1, generator=g)
    assert torch.equal(variance_mouth_boxes(x.to(dev)).cpu(), variance_mouth_boxes(x))
    y = torch.arange(1, 288, dtype=torch.float32)
    assert torch.equal(true_div(y.to(dev), 288).cpu(), y / 288)
    loc = localizer.load_bundled_or_none(dev)
    heur = torch.tensor([0.6, 1.0, 0.3, 0.7])
    card = localizer.gate_boxes(x.to(dev), localizer.localize_clip_boxes(loc, x.to(dev)),
                                heur.to(dev)).cpu()
    cpu_loc = copy.deepcopy(loc).cpu()
    host = localizer.gate_boxes(x, localizer.localize_clip_boxes(cpu_loc, x), heur)
    assert torch.equal((card == heur).all(-1), (host == heur).all(-1))
    torch.testing.assert_close(card, host, rtol=0, atol=1e-5)
