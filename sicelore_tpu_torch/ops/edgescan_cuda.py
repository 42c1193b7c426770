"""Edge-scan kernel wrapper (csrc/edgescan.cu) and the edge scan's dispatch.

The kernel replaces the Pallas kernel
`sicelore_tpu/ops/edgescan_tpu.py::_edge_kernel`. For CPU tensors `edge_scan2`
runs the plain body `edgescan.edge_scan2_plain`. For CUDA tensors a config
inside the kernel's envelope launches the fused kernel, and a config outside
it (5p chemistry first of all) runs `edgescan.edge_scan2_composed`: the body
as torch ops on the card with its adapter searches through the window-search
kernel, the route `edgescan_tpu.make_edge_scan2_packed` takes for such
configs in the JAX package. A kernel that fails raises; nothing falls back.
"""
from __future__ import annotations

import numpy as np
import torch

from sicelore_tpu_torch.ops import _build, scan
from sicelore_tpu_torch.ops import edgescan as eg

MAXP = 16   # bailout threshold pairs the kernel holds (csrc/edgescan.cu)


def kernel_params(p: eg.EdgeParams) -> np.ndarray:
    """The int32 parameter array matching csrc/edgescan.cu::EdgeParams."""
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
            p.bc_len, p.bw, eg.ROW_BC0 + p.bw]
    return np.ascontiguousarray(np.concatenate(
        [np.asarray(head, np.int32), peqs, np.asarray(px + py, np.int32)]))


def edge_scan2(codes_tm: torch.Tensor, lens: torch.Tensor,
               p: eg.EdgeParams) -> torch.Tensor:
    """Edge scan of text-major int8 codes [2E, B] (PAD outside the read) and
    lens [B] int32 -> meta rows [14 + bw, B] int32 (ops.edgescan ROW_*)."""
    if codes_tm.dim() != 2 or codes_tm.shape[0] != 2 * eg.E:
        raise ValueError(f"codes_tm must be [2E={2 * eg.E}, B], "
                         f"got {tuple(codes_tm.shape)}")
    B = codes_tm.shape[1]
    if codes_tm.device.type == "cpu":
        return eg.edge_scan2_plain(codes_tm[:eg.E].t(), codes_tm[eg.E:].t(),
                                   lens, p)
    if codes_tm.dtype != torch.int8 or not codes_tm.is_contiguous():
        raise ValueError("codes_tm must be contiguous int8")
    if (lens.dtype != torch.int32 or lens.shape != (B,)
            or lens.device != codes_tm.device or not lens.is_contiguous()):
        raise ValueError("lens must be contiguous int32 [B] on codes' device")
    if p.kernel_unsupported:
        return eg.edge_scan2_composed(codes_tm[:eg.E].t().contiguous(),
                                      codes_tm[eg.E:].t().contiguous(),
                                      lens, p)
    out = torch.empty((eg.ROW_BC0 + p.bw, B), dtype=torch.int32,
                      device=codes_tm.device)
    if B == 0:
        return out
    prm = kernel_params(p)
    fn = _build.bind("edgescan", "edgescan_launch", 4, 2)
    _build.check(fn(codes_tm.data_ptr(), lens.data_ptr(), out.data_ptr(),
                    prm.ctypes.data, B, prm.size,
                    _build.stream_handle(codes_tm.device)), "edgescan")
    edge_scan2.launches += 1
    return out


edge_scan2.launches = 0
