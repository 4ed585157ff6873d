"""The port's device-length CTC (`avsync_torch.ops.ctc`) against the JAX
package's `ctc_loss_mean` (optax's recursion) and against `F.ctc_loss`, for
the loss and its gradient, on the CPU.

Tolerances: rtol 1e-5 against the JAX package (the same recursion in fp32,
sums in another order; the gradient with atol 1e-6 for its near-zero
entries); against `F.ctc_loss`, a different algorithm (alpha-beta with its
own log-sum-exp), rtol 1e-5 on the loss and atol 1e-5 on the gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from avsync.ops.ctc import ctc_loss_mean as jax_ctc
from avsync_torch.ops.ctc import ctc_loss_mean, ctc_nll

B, T, V, L = 5, 12, 7, 6


def _case(seed):
    r = np.random.default_rng(seed)
    logits = r.standard_normal((B, T, V)).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(logits, -1))
    labels = r.integers(1, V, (B, L)).astype(np.int32)
    labels[1, 1] = labels[1, 0]  # a repeated pair
    labels[3, 2:4] = labels[3, 1]  # a run of three
    lengths = np.array([6, 3, 0, 5, 2], np.int32)  # a label length 0
    for b in range(B):
        labels[b, lengths[b]:] = 0
    return lp, labels, lengths


def _ours(lp, labels, lengths, frames=None):
    x = torch.tensor(lp, requires_grad=True)
    loss = ctc_loss_mean(x, torch.from_numpy(labels), torch.from_numpy(lengths),
                         None if frames is None else torch.from_numpy(frames))
    loss.backward()
    return loss.item(), x.grad.numpy()


@pytest.mark.parametrize("frames", [None, [12, 3, 12, 7, 1]],
                         ids=["all_frames", "input_lengths_with_infeasible_rows"])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_gradient_match_jax(seed, frames):
    """With input lengths 3 for 3 labels plus a repeat (needs 4 frames) and
    1 for 2 labels, two rows have no alignment: zero_infinity drops them
    (and their gradient) in both packages."""
    lp, labels, lengths = _case(seed)
    fr = None if frames is None else np.asarray(frames, np.int32)

    def jloss(x):
        return jax_ctc(x, jnp.asarray(labels), jnp.asarray(lengths),
                       None if fr is None else jnp.asarray(fr))

    want, want_g = float(jloss(jnp.asarray(lp))), np.asarray(jax.grad(jloss)(jnp.asarray(lp)))
    got, got_g = _ours(lp, labels, lengths, fr)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("frames", [None, [12, 3, 12, 7, 1]],
                         ids=["all_frames", "input_lengths_with_infeasible_rows"])
def test_loss_and_gradient_match_torch_ctc_loss(frames):
    lp, labels, lengths = _case(2)
    fr = np.full(B, T, np.int32) if frames is None else np.asarray(frames, np.int32)
    x = torch.tensor(lp, requires_grad=True)
    want = F.ctc_loss(x.transpose(0, 1), torch.from_numpy(labels).long(),
                      torch.from_numpy(fr).long(), torch.from_numpy(lengths).long(), blank=0,
                      reduction="mean", zero_infinity=True)
    want.backward()
    got, got_g = _ours(lp, labels, lengths, None if frames is None else fr)
    np.testing.assert_allclose(got, want.item(), rtol=1e-5)
    np.testing.assert_allclose(got_g, x.grad.numpy(), atol=1e-5)


def test_label_length_zero_is_the_blank_path():
    """An empty target's likelihood is the all-blank path: -sum_t lp[t, blank]
    (torch's mean divides it by max(length, 1) = 1)."""
    lp, labels, lengths = _case(3)
    nll = ctc_nll(torch.from_numpy(lp), torch.from_numpy(labels), torch.from_numpy(lengths))
    np.testing.assert_allclose(nll[2].item(), -lp[2, :, 0].sum(dtype=np.float64), rtol=1e-6)


def test_lengths_stay_on_the_device_side():
    """Lengths given as tensors are never read as host numbers: the loss of
    one batch differs from another's only through the tensors' values (a
    captured step replays with other lengths)."""
    lp, labels, lengths = _case(4)
    other = lengths.copy()
    other[0] = 4
    labels2 = labels.copy()
    labels2[0, 4:] = 0
    a = ctc_loss_mean(torch.from_numpy(lp), torch.from_numpy(labels), torch.from_numpy(lengths))
    b = ctc_loss_mean(torch.from_numpy(lp), torch.from_numpy(labels2), torch.from_numpy(other))
    want = float(jax_ctc(jnp.asarray(lp), jnp.asarray(labels2), jnp.asarray(other)))
    assert a.item() != b.item()
    np.testing.assert_allclose(b.item(), want, rtol=1e-5)
