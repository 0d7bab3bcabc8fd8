"""GF(2^255 - 19) multiply kernel on the H100 — wrapper and plain version.

Replaces ``dag_rider_tpu/ops/pallas_field.py::_mul_kernel``: one field
multiply per lane, step for step as :func:`field.mul`. It is the unit
kernel of ``mul22``, the device function the addition and tree kernels of
``csrc/ed25519_group.cu`` are built from (the finish and pow22523 kernels
split each product over a group of lanes instead); nothing on the verify
path calls it. Bound by integer multiply-adds (484 per product plus ~600
carry and fold operations); the design holds the 22 limbs of both operands
and the 46 columns in registers, so device memory sees one read of each
operand and one write of the result.
"""

from __future__ import annotations

import torch

from dag_rider_tpu_torch.ops import cuda_group, field as F

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"field_mul": 0}


def reset_launches() -> None:
    LAUNCHES["field_mul"] = 0


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: :func:`field.mul`."""
    return F.mul(a, b)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b (mod p) for int32 [..., 22] operands of one shape -> [..., 22].

    Transposes to limb-major [22, N], runs the kernel, transposes back."""
    if a.shape != b.shape or a.shape[-1:] != (F.LIMBS,):
        raise ValueError(f"mul: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("mul: operands on different devices")
    at = a.reshape(-1, F.LIMBS).t().contiguous()
    bt = b.reshape(-1, F.LIMBS).t().contiguous()
    cuda_group.check_operand(at, F.LIMBS, "a")
    cuda_group.check_operand(bt, F.LIMBS, "b")
    if a.device.type == "cpu":
        return mul_plain(a, b)
    n = at.shape[1]
    out = torch.empty((F.LIMBS, n), dtype=torch.int32, device=a.device)
    cuda_group.launch("dr_field_mul", a.device, at.data_ptr(), bt.data_ptr(),
                      out.data_ptr(), n)
    LAUNCHES["field_mul"] += 1
    return out.t().reshape(a.shape)
