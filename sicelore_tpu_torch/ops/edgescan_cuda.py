"""Edge-scan kernel wrapper (csrc/edgescan.cu) and the edge scan's dispatch.

The kernel replaces the Pallas kernel
`sicelore_tpu/ops/edgescan_tpu.py::_edge_kernel` and takes both chemistries.
For CPU tensors `edge_scan2` runs the plain body `edgescan.edge_scan2_plain`.
For CUDA tensors a config inside the kernel's envelope launches the fused
kernel, and a config outside it (an adapter window over 128 columns, say)
runs `edgescan.edge_scan2_composed`: the body as torch ops on the card with
its adapter searches through the window-search kernel, the route
`edgescan_tpu.make_edge_scan2_packed` takes for such configs in the JAX
package. A kernel that fails raises; nothing falls back.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from sicelore_tpu_torch.ops import _build, scan
from sicelore_tpu_torch.ops import edgescan as eg

MAXP = 16   # bailout threshold pairs the kernel holds (csrc/edgescan.cu)


@functools.lru_cache(maxsize=64)
def kernel_params(p: eg.EdgeParams) -> np.ndarray:
    """The int32 parameter array matching csrc/edgescan.cu::EdgeParams
    (built once a parameter object)."""
    pairs = scan.bail_pairs(p.c1, p.c2)
    if len(pairs) > MAXP:
        raise ValueError(f"{len(pairs)} bailout pairs exceed the kernel's "
                         f"{MAXP}")
    px = [x for x, _ in pairs] + [0] * (MAXP - len(pairs))
    py = [y for _, y in pairs] + [0] * (MAXP - len(pairs))
    peqs = np.concatenate([p.peq_ad[:, 0], p.peq_adc[:, 0],
                           p.peq_tso[:, 0]]).view(np.int32)
    head = [eg.E, p.k, p.mc, p.win_p, p.awin, p.twin, p.m_ad, p.m_adc,
            p.m_tso, p.mm_ad, p.mm_tso, p.off_tso, p.c1, len(pairs), p.pad,
            p.bc_len, p.bw, eg.ROW_BC0 + p.bw, int(p.is5p), p.c2]
    return np.ascontiguousarray(np.concatenate(
        [np.asarray(head, np.int32), peqs, np.asarray(px + py, np.int32)]))


def edge_scan2(codes: torch.Tensor, lens: torch.Tensor,
               p: eg.EdgeParams) -> torch.Tensor:
    """Edge scan of the rows of `encode_two_half`: int8 codes [B, 2E] (head
    columns, then the right-aligned tail; PAD outside the read) and lens [B]
    int32 -> meta rows [14 + bw, B] int32 (ops.edgescan ROW_*). On the card
    the rows must be contiguous and 16-byte aligned (the kernel stages them
    with 16-byte loads)."""
    if codes.dim() != 2 or codes.shape[1] != 2 * eg.E:
        raise ValueError(f"codes must be [B, 2E={2 * eg.E}], "
                         f"got {tuple(codes.shape)}")
    B = codes.shape[0]
    head, tail = codes[:, :eg.E], codes[:, eg.E:]
    if codes.device.type == "cpu":
        return eg.edge_scan2_plain(head, tail, lens, p)
    if codes.dtype != torch.int8 or not codes.is_contiguous():
        raise ValueError("codes must be contiguous int8")
    if codes.data_ptr() % 16:
        raise ValueError("codes must start on a 16-byte boundary")
    if (lens.dtype != torch.int32 or lens.shape != (B,)
            or lens.device != codes.device or not lens.is_contiguous()):
        raise ValueError("lens must be contiguous int32 [B] on codes' device")
    if p.kernel_unsupported:
        return eg.edge_scan2_composed(head, tail, lens, p)
    out = torch.empty((eg.ROW_BC0 + p.bw, B), dtype=torch.int32,
                      device=codes.device)
    if B == 0:
        return out
    prm = kernel_params(p)
    fn = _build.bind("edgescan", "edgescan_launch", 4, 2)
    _build.launch(fn, "edgescan", codes.device, codes.data_ptr(),
                  lens.data_ptr(), out.data_ptr(), prm.ctypes.data, B,
                  prm.size)
    edge_scan2.launches += 1
    edge_scan2.launches_5p += bool(p.is5p)
    return out


edge_scan2.launches = 0
# the share of `launches` made with 5p parameters
edge_scan2.launches_5p = 0
