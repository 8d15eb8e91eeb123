"""Losses: CE with an ignore label, OHEM CE and BCE with logits, NCHW.

Counterpart of ``dasemanticsegmentationaml_tpu/ops/losses.py``
(``cross_entropy_ignore`` :43-58, ``ohem_cross_entropy`` :61-90,
``bce_with_logits`` :93-101), after the reference's
``CrossEntropyLoss(ignore_index=255)`` on each head (train.py:66,86-89),
``OHEM_CrossEntroy_Loss`` (utils.py:256-271) and the discriminator's
``BCEWithLogitsLoss`` (train.py:173).

A pixel counts when ``label != ignore_index and 0 <= label < C`` (JAX
losses.py:27): labels 19..254 are not an error, they are skipped. The
labels are masked before they index anything, so no label reaches an
index op out of range (``F.cross_entropy`` on a CUDA tensor asserts on
them). An all-ignored batch gives loss 0 and zero gradients, because the
count is clamped to 1 (JAX losses.py:48-58), where torch's
``reduction='mean'`` would give NaN. Reductions run in fp32 whatever the
logits' dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _per_pixel_ce(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C, H, W) logits, (B, H, W) integer labels -> fp32 per-pixel loss
    (0 where not valid) and the valid mask (JAX losses.py:23-40)."""
    logits = logits.float()
    num_classes = logits.shape[1]
    valid = (labels != ignore_index) & (labels >= 0) & (labels < num_classes)
    safe = torch.where(valid, labels, 0).long()
    m = logits.amax(dim=1, keepdim=True).detach()
    lse = m.squeeze(1) + torch.log(torch.exp(logits - m).sum(dim=1))
    picked = logits.gather(1, safe.unsqueeze(1)).squeeze(1)
    return torch.where(valid, lse - picked, 0.0), valid


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = 255) -> torch.Tensor:
    """Mean CE over the valid pixels; 0 when there are none."""
    loss, valid = _per_pixel_ce(logits, labels, ignore_index)
    count = valid.sum().float().clamp_min(1.0)
    return loss.sum() / count


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       threshold: float, keep_num: int,
                       ignore_index: int = 255) -> torch.Tensor:
    """Online hard example mining CE (JAX losses.py:61-90): if the
    ``keep_num``-th largest pixel loss exceeds ``threshold``, the mean of
    every loss above it, else the mean of the top ``keep_num``."""
    loss, valid = _per_pixel_ce(logits, labels, ignore_index)
    flat = torch.where(valid.reshape(-1), loss.reshape(-1), -torch.inf)
    sorted_desc = torch.sort(flat, descending=True).values
    k = min(keep_num, flat.numel() - 1)
    kth = sorted_desc[k]

    above = sorted_desc > threshold
    n_above = above.sum().float().clamp_min(1.0)
    mean_above = torch.where(above, sorted_desc, 0.0).sum() / n_above

    topk = sorted_desc[:k]
    finite = torch.isfinite(topk)
    n_topk = finite.sum().float().clamp_min(1.0)
    mean_topk = torch.where(finite, topk, 0.0).sum() / n_topk
    return torch.where(kth > threshold, mean_above, mean_topk)


def bce_with_logits(logits: torch.Tensor, target: float,
                    count: Optional[int] = None) -> torch.Tensor:
    """Mean BCE-with-logits against a constant ``target`` (the domain
    label), in fp32: ``max(x, 0) - x*y + log1p(exp(-|x|))`` (JAX
    losses.py:93-101, torch's stable form). ``count``: the sum over it
    instead of the mean (a band's share of a global mean)."""
    x = logits.float()
    loss = torch.clamp_min(x, 0.0) - x * float(target) \
        + torch.log1p(torch.exp(-x.abs()))
    return loss.mean() if count is None else loss.sum() / count
