"""Gradient compression with error feedback, the counterpart of
``repro/optim/compression.py`` on both bindings (the cross-pod hop's
distributed-optimization trick).

int8 error-feedback all-reduce: quantize (g + carried error) to int8 with
one scale for every participant, sum the int8 payloads (8× fewer wire bytes
than float32 a hop), carry the quantization residual into the next step.
EF guarantees the *sum* of applied updates converges to the sum of true
gradients (Karimireddy et al., 2019) — the residual never leaves its
participant, a LOCO private local region attached to the channel.

Where the reference runs per participant under ``shard_map``/``vmap`` with
``pmax`` / ``psum`` over an axis name, the stacked binding takes the
stacked tensor and reduces over its participant dimension
(:func:`int8_ef_allreduce`), and the process binding all-reduces over a
named axis of a :class:`~repro_torch.launch.mesh.ProcessMesh`
(:func:`int8_ef_allreduce_process`: the scale by an all-reduce MAX, the
int8 payloads summed in int32).  ``torch.round`` and
``jnp.round`` both round half to even, so the payload is the reference's
bit for bit.  Every division here divides by a tensor on the operand's
device: PyTorch's CUDA kernels divide by a Python scalar as a product with
its reciprocal, which can round one bit off the quotient, so a scale on
the card would differ from the CPU's and the reference's (and with it the
payload).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..tree import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x → (int8 payload, its scale max(|x|)/127 in x's dtype) for one
    tensor."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / x.new_tensor(127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def int8_payload(gf: torch.Tensor, dim: int, lead: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 payloads of float32 ``gf`` and their one scale: each
    participant's max |value| / 127 (its tensor is what follows ``gf``'s
    first ``lead`` dims, default ``dim + 1``), then the max of those over
    ``dim`` (the reference's ``pmax``, one scalar on the wire), kept with
    size 1 there."""
    lead = dim + 1 if lead is None else lead
    local = gf.abs().reshape(*gf.shape[:lead], -1).amax(-1)
    local = torch.clamp(local, min=1e-12) / local.new_tensor(127.0)
    scale = local.amax(dim, keepdim=True)
    scale = scale.reshape(*scale.shape, *(1,) * (gf.dim() - lead))
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_ef_allreduce(g: torch.Tensor, dim: int,
                      error: Optional[torch.Tensor] = None, *,
                      lead: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 mean over participant dimension ``dim`` of the
    stacked ``g`` (the participants are its first ``lead`` dims, default
    ``dim + 1``; ``error`` is g's shape).  Returns (synced float32, every
    participant holding the mean, new error).  The payloads share one
    scale, so they sum exactly in int32 and each participant's residual is
    exactly what its peers did not apply; the output is ``summed · scale /
    n``, in the reference's order."""
    gf = g.float()
    if error is not None:
        gf = gf + error
    q, scale = int8_payload(gf, dim, lead)
    sent = q.float() * scale
    new_error = gf - sent
    summed = q.to(torch.int32).sum(dim, keepdim=True).float()
    out = summed * scale / gf.new_tensor(float(gf.shape[dim]))
    return out.expand(gf.shape), new_error


def int8_payload_process(gf: torch.Tensor, mesh, axis: str
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`int8_payload` on one rank of a process mesh: float32 ``gf``'s
    int8 payload and the one scale every rank of ``axis`` quantizes with —
    this rank's max |value| / 127, then the max of those over ``axis`` (an
    all-reduce MAX of one scalar, the reference's ``pmax``)."""
    from ..distributed import collectives as CL
    local = torch.clamp(gf.abs().max(), min=1e-12) / gf.new_tensor(127.0)
    scale = CL.pmax(local, mesh, axis)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_ef_allreduce_process(g: torch.Tensor, mesh, axis: str,
                              error: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`int8_ef_allreduce` on one rank of a process mesh: the mean
    over ``axis``'s ranks of this rank's ``g`` (+ ``error``), quantized
    with :func:`int8_payload_process`'s one scale and the payloads summed
    in int32.  Returns (synced float32, new error), the error never
    leaving the rank."""
    from ..distributed import collectives as CL
    gf = g.float()
    if error is not None:
        gf = gf + error
    q, scale = int8_payload_process(gf, mesh, axis)
    sent = q.float() * scale
    new_error = gf - sent
    summed = CL.psum(q.to(torch.int32), mesh, axis).float()
    out = summed * scale / gf.new_tensor(float(mesh.shape[axis]))
    return out, new_error


def compression_error_init(grads):
    """A float32 zero error state shaped as each gradient leaf."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
