"""Plain PyTorch version of the Mamba-2 SSD chunk kernel, ported from
``repro.kernels.ssd_scan.ref``: the semantics the CUDA kernel in
``repro_torch/csrc/ssd_scan.cu`` is held to, at tolerance.

It takes the model layout the wrapper and the kernel take (the reference's
oracle takes the TPU kernel's ``(B*H, nc, Q, ...)`` layout), and it is the
intra-chunk path of `repro_torch.models.ssm.ssd_chunked` when the kernel is
off. Its decay matrix comes from the given cumulative sum ``dA_cs``, as the
TPU kernel builds it (``ssd_scan.py:33-39``), where the reference's oracle
sums ``dA`` once more: on the card a second cumulative sum rounds
differently, and at jamba's decay rates ``dA_cs`` falls to about -3000,
where one ulp is 2.4e-4 in the exponent.
"""
from typing import Tuple

import torch


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T) where out[..., i, j] = sum_{j < k <= i}
    x[..., k]: lower-triangular cumulative segment sums (the Mamba-2 paper's
    ``segsum``); -inf above the diagonal."""
    return segsum_of_cumsum(torch.cumsum(x, dim=-1))


def segsum_of_cumsum(cs: torch.Tensor) -> torch.Tensor:
    """`segsum` given the cumulative sum ``cs`` of its input:
    out[..., i, j] = cs[..., i] - cs[..., j] for j <= i, else -inf."""
    T = cs.shape[-1]
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=cs.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, dA: torch.Tensor,
                  dA_cs: torch.Tensor, B: torch.Tensor, C: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,nc,Q,H,P); dt, dA, dA_cs (B,nc,Q,H) f32; B, C (B,nc,Q,H,N).
    Returns (Y_diag (B,nc,Q,H,P), states (B,nc,H,P,N)), both f32:

        Y_diag[q, p] = sum_{s<=q} (C[q].B[s]) exp(cs[q] - cs[s]) dt[s] x[s, p]
        state[p, n]  = sum_q B[q, n] exp(cs[-1] - cs[q]) dt[q] x[q, p]

    ``dA`` enters through its cumulative sum ``dA_cs`` only, as in the
    kernel; it stays in the signature of the reference's ``ssd_chunk``.
    """
    # exp(-inf) = 0 above the diagonal: masked by select, never by a product
    Lmat = torch.exp(segsum_of_cumsum(dA_cs.movedim(3, 2)))  # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bcshn->bchqs", C.float(), B.float())
    scores = scores * Lmat * dt.movedim(3, 2)[..., None, :]
    y = torch.einsum("bchqs,bcshp->bcqhp", scores, x.float())
    decay = torch.exp(dA_cs[:, :, -1:] - dA_cs) * dt         # (B,nc,Q,H)
    states = torch.einsum("bcqhn,bcqhp->bchpn", B.float(),
                          x.float() * decay[..., None])
    return y, states
