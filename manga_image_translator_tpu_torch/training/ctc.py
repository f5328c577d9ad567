"""Multi-label CTC loss with real-valued (colour) targets — PyTorch port.

Counterpart of the JAX package's ``training/ctc.py`` (contract from the
reference's native training kernel ``training/ocr/custom_ctc.cc`` /
``custom_ctc_kernel.cu``, math per training/ocr/README.md): Graves CTC
extended per Wigington's multi-label CTC — each non-blank emission also
pays a Gaussian log-likelihood for R real-valued channels (font / border
colours), and a second blank symbol ``blank1`` (the space character) masks
that term.

The alpha recursion runs over time in plain PyTorch, the (batch, 2S + 1)
lattice vectorised; the gradient comes from autograd and is the true
d loss / d log_probs (minus the posterior), as JAX autodiff gives it.
torch's native ``ctc_loss`` is not used: its gradient is in the logits
convention (exp(log_probs) - posterior) and it has no colour term. The
JAX package has no Pallas kernel here either (``lax.scan`` + autodiff).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _gauss_log(x, mu, sigma: float):
    """log N(x | mu, sigma) (reference custom_distance_forward_log)."""
    return (-0.5 * math.log(2.0 * math.pi) - math.log(sigma)
            - 0.5 * (x - mu) ** 2 / (sigma ** 2))


def _shift(a: torch.Tensor, k: int) -> torch.Tensor:
    """a shifted right by k along the lattice axis, NEG_INF coming in."""
    return torch.cat([a.new_full((a.shape[0], k), NEG_INF), a[:, :-k]], 1)


def custom_ctc_loss(log_probs: torch.Tensor, targets: torch.Tensor,
                    realval: Optional[torch.Tensor],
                    targets_realval: Optional[torch.Tensor],
                    input_lengths: torch.Tensor,
                    target_lengths: torch.Tensor, sigma: float = 1.0,
                    blank: int = 0, blank1: int = 0,
                    reduction: str = 'mean') -> torch.Tensor:
    """CTC loss with per-step Gaussian colour emissions.

    Args:
      log_probs: (N, T, V) log-softmaxed class scores.
      targets: (N, S) int labels (padded).
      realval: (N, T, R) predicted real values per step, or None.
      targets_realval: (N, S, R) target real values per label, or None.
      input_lengths / target_lengths: (N,) ints.
      blank: CTC blank id; blank1: second blank masking the real-value term.
      reduction: 'none' (per sample), 'mean' (the mean of each loss over
        its target length, reference custom_ctc.py:35-37) or 'sum'.
    """
    if reduction not in ('none', 'mean', 'sum'):
        raise ValueError(f'reduction {reduction!r}')
    n, t_max, _ = log_probs.shape
    s_max = targets.shape[1]
    ext_len = 2 * s_max + 1
    dev = log_probs.device
    targets = targets.to(dev).long()
    input_lengths = input_lengths.to(dev)
    target_lengths = target_lengths.to(dev)

    # extended target sequence: blank, y1, blank, y2, ... blank
    ext = torch.full((n, ext_len), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = targets

    # emission matrix (N, T, 2S+1): class log-prob + Gaussian colour term
    emis = torch.gather(log_probs, 2,
                        ext[:, None, :].expand(n, t_max, ext_len))
    if realval is not None and targets_realval is not None \
            and realval.shape[-1] > 0:
        gauss_lab = _gauss_log(targets_realval[:, None, :, :],
                               realval[:, :, None, :], sigma).sum(-1)
        gauss = torch.zeros((n, t_max, ext_len), dtype=emis.dtype,
                            device=dev)
        gauss[:, :, 1::2] = gauss_lab
        is_real = (ext != blank) & (ext != blank1)
        emis = emis + torch.where(is_real[:, None, :], gauss,
                                  torch.zeros((), dtype=emis.dtype,
                                              device=dev))

    # alpha[s] can come from s, s-1, and s-2 when the s-2 label differs and
    # s is a label position
    ext_prev2 = torch.cat([ext.new_full((n, 2), blank), ext[:, :-2]], 1)
    can_skip = (ext != blank) & (ext != ext_prev2)
    valid_s = (torch.arange(ext_len, device=dev)[None, :]
               < (2 * target_lengths[:, None] + 1))
    has_tgt = target_lengths > 0
    neg = torch.full((), NEG_INF, dtype=emis.dtype, device=dev)

    alpha = torch.full((n, ext_len), NEG_INF, dtype=emis.dtype, device=dev)
    first = torch.zeros_like(alpha, dtype=torch.bool)
    first[:, 0] = True
    alpha = torch.where(first, emis[:, 0], alpha)
    second = torch.zeros_like(first)
    second[:, 1] = True
    alpha = torch.where(second & has_tgt[:, None], emis[:, 0], alpha)
    alpha = torch.where(valid_s, alpha, neg)

    for t in range(1, t_max):
        a_prev2 = torch.where(can_skip, _shift(alpha, 2), neg)
        stacked = torch.stack([alpha, _shift(alpha, 1), a_prev2], 0)
        new_alpha = torch.logsumexp(stacked, 0) + emis[:, t]
        new_alpha = torch.where(valid_s, new_alpha, neg)
        # steps beyond each sample's input length freeze alpha
        alpha = torch.where((t < input_lengths)[:, None], new_alpha, alpha)

    end1 = 2 * target_lengths                          # final blank
    end2 = torch.clamp(2 * target_lengths - 1, min=0)  # final label
    a1 = torch.gather(alpha, 1, end1[:, None].long())[:, 0]
    a2 = torch.where(has_tgt,
                     torch.gather(alpha, 1, end2[:, None].long())[:, 0],
                     neg)
    nll = -torch.logsumexp(torch.stack([a1, a2], 0), 0)

    if reduction == 'mean':
        return torch.mean(nll / torch.clamp(target_lengths, min=1))
    if reduction == 'sum':
        return nll.sum()
    return nll
