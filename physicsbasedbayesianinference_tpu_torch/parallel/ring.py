"""Ring-parallel O(N^2) N-body forces over a group of processes (port of the
JAX package's ``parallel/ring.py``).

Bodies are split over the group, each rank keeps its block resident, and
the partner blocks rotate around the ring (``mesh.ring_shift``, JAX's
``ppermute`` with the permutation ``(j, j - 1)``): after K steps every
rank has the forces of all N bodies on its own while holding 2 N / K
positions. Each step's tile, the accelerations of the rank's bodies from
the visiting block, is kernel E's source-block launch on a CUDA rank
(``ops.kernels.nbody_accelerations_tiled(..., sources=...)``) and its
plain version on a CPU rank. The energy's pair sums (:func:`_block_pot`)
are plain torch, as in the JAX package.

The functions take the global arrays, the same on every rank (the JAX
package's inputs are global arrays too), and return this rank's block of
what is per body; the energies are the group's, on every rank. N must be
divisible by the group's size (:func:`pad_bodies`). A group of one is the
dense computation.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..constants import Constants, NATURAL
from ..ops import kernels
from .mesh import WalkerMesh, make_walker_mesh, ring_shift

Tensor = torch.Tensor

BODY_AXIS = "bodies"
# float elements of one [rows, N] pair block of the energy's sum
_POT_PAIR_BLOCK = 1 << 24


def make_body_mesh(group=None, *, device=None,
                   axis_name: str = BODY_AXIS) -> WalkerMesh:
    """The group over the body axis (``mesh.make_walker_mesh`` with the
    axis name ``bodies``)."""
    return make_walker_mesh(group, device=device, axis_name=axis_name)


def pad_bodies(x: Tensor, mass: Tensor, multiple: int,
               v: Optional[Tensor] = None):
    """Pad with zero-mass bodies so that N is a multiple of ``multiple``:
    ``(x_pad, mass_pad[, v_pad], n_original)``. Zero-mass sources pull
    nothing; the padded targets' accelerations are to be dropped. The
    padding lies on a distant line (1e6 (1 + max|x|) times 1, 2, ...), so
    that no two bodies coincide (0 * inf would be NaN at eps = 0)."""
    n = x.shape[0]
    extra = -(-n // multiple) * multiple - n
    if extra == 0:
        out = (x, mass) if v is None else (x, mass, v)
        return (*out, n)
    scale = 1e6 * (1.0 + torch.max(torch.abs(x)))
    sent = torch.zeros((extra, x.shape[1]), dtype=x.dtype, device=x.device)
    sent[:, 0] = scale * (1.0 + torch.arange(extra, dtype=x.dtype,
                                             device=x.device))
    x_pad = torch.cat([x, sent])
    mass_pad = torch.cat([mass, mass.new_zeros(extra)])
    if v is None:
        return x_pad, mass_pad, n
    return x_pad, mass_pad, torch.cat([v, v.new_zeros(extra, v.shape[1])]), n


def _block_pot(xi: Tensor, mi: Tensor, xj: Tensor, mj: Tensor, *,
               soft2: float, mask_self: bool) -> Tensor:
    """``sum_{i in block i, j in block j} m_i m_j / r_ij`` (each ordered
    pair once; pairs at r^2 <= 0, and with ``mask_self`` the block's own
    diagonal, left out), over row blocks of the targets."""
    rows = max(1, _POT_PAIR_BLOCK // xj.shape[0])
    cols = torch.arange(xj.shape[0], device=xj.device)
    total = torch.zeros((), dtype=xi.dtype, device=xi.device)
    for start in range(0, xi.shape[0], rows):
        stop = min(xi.shape[0], start + rows)
        dr = xj[None, :, :] - xi[start:stop, None, :]
        r2 = torch.sum(dr * dr, dim=-1) + soft2
        zero = r2 <= 0.0
        if mask_self:
            zero = zero | (cols[None, :] == torch.arange(
                start, stop, device=xi.device)[:, None])
        inv_r = torch.where(zero, 0.0,
                            torch.rsqrt(torch.where(zero, 1.0, r2)))
        total = total + torch.sum((mi[start:stop, None] * mj[None, :])
                                  * inv_r)
    return total


def _ring_sweep(x_blk: Tensor, m_blk: Tensor, mesh: WalkerMesh, *,
                g: float, softening: float, want_acc: bool = True,
                want_pot: bool = False):
    """One pass of the ring: this block's accelerations from all K blocks
    (its own first, then the others in ring order) and, with ``want_pot``,
    its partial pair sum."""
    acc = None
    pot = torch.zeros((), dtype=x_blk.dtype, device=x_blk.device)
    xj, mj = x_blk, m_blk
    for s in range(mesh.size):
        if want_acc:
            a = kernels.nbody_accelerations_tiled(
                x_blk, None, g_const=g, softening=softening,
                sources=(xj, mj))
            acc = a if acc is None else acc + a
        if want_pot:
            pot = pot + _block_pot(x_blk, m_blk, xj, mj,
                                   soft2=float(softening) ** 2,
                                   mask_self=(s == 0))
        if s + 1 < mesh.size:
            xj, mj = ring_shift((xj, mj), mesh)
    return acc, pot


def _blocks(mesh: WalkerMesh, *arrays: Tensor) -> list:
    n = arrays[0].shape[0]
    if n % mesh.size != 0:
        raise ValueError(f"num_bodies={n} must be divisible by the mesh "
                         f"size {mesh.size}; pad with pad_bodies()")
    return [torch.as_tensor(a)[mesh.block(n)].to(mesh.device).contiguous()
            for a in arrays]


def _psum(values: Tensor, mesh: WalkerMesh) -> Tensor:
    values = values.clone()
    dist.all_reduce(values, group=mesh.group)
    return values


def ring_nbody_accelerations(x: Tensor, mass: Tensor, *, mesh: WalkerMesh,
                             constants: Constants = NATURAL,
                             softening: float = 0.0) -> Tensor:
    """``a_i = G sum_{j != i} m_j r_ij / |r_ij|^3`` for this rank's block of
    the bodies ``x`` ``[N, 3]``, ``mass`` ``[N]``, summed over the blocks
    in ring order from the rank's own."""
    x_blk, m_blk = _blocks(mesh, x, mass)
    return _ring_sweep(x_blk, m_blk, mesh, g=constants.G,
                       softening=softening)[0]


def ring_nbody_potential_energy(x: Tensor, mass: Tensor, *,
                                mesh: WalkerMesh,
                                constants: Constants = NATURAL,
                                softening: float = 0.0) -> Tensor:
    """``-G sum_{i<j} m_i m_j / r_ij``, the group's, on every rank: each
    ordered pair counted once on its target's rank, the partial sums
    all-reduced and halved."""
    x_blk, m_blk = _blocks(mesh, x, mass)
    _, pot = _ring_sweep(x_blk, m_blk, mesh, g=constants.G,
                         softening=softening, want_acc=False, want_pot=True)
    return -0.5 * constants.G * _psum(pot, mesh)


def ring_simulate(x: Tensor, v: Tensor, mass: Tensor, dt, *, num_steps: int,
                  mesh: WalkerMesh, save_every: int = 1,
                  constants: Constants = NATURAL, softening: float = 0.0):
    """Velocity Verlet with ring forces, one sweep a step (each step reuses
    the previous step's accelerations): ``(x_final, v_final, energies)``,
    the first two this rank's block, ``energies`` ``[num_steps //
    save_every]`` the group's total energy after every ``save_every``
    steps (one all-reduce each). On a CUDA rank a step is K launches of
    kernel E's source-block form (K more to start), the energies none;
    nothing in the loop is read back to the host."""
    if num_steps % save_every != 0:
        raise ValueError(f"num_steps={num_steps} must be a multiple of "
                         f"save_every={save_every}")
    x_blk, v_blk, m_blk = _blocks(mesh, x, v, mass)
    g = constants.G
    dt = torch.as_tensor(dt, dtype=x_blk.dtype, device=x_blk.device)

    def accel(xb):
        return _ring_sweep(xb, m_blk, mesh, g=g, softening=softening)[0]

    def energy(xb, vb):
        _, pot = _ring_sweep(xb, m_blk, mesh, g=g, softening=softening,
                             want_acc=False, want_pot=True)
        kin = 0.5 * torch.sum(m_blk * torch.sum(vb * vb, dim=-1))
        kin_pot = _psum(torch.stack((kin, pot)), mesh)
        return kin_pot[0] - 0.5 * g * kin_pot[1]

    a_blk = accel(x_blk)
    energies = []
    for _ in range(num_steps // save_every):
        for _ in range(save_every):
            vh = v_blk + 0.5 * dt * a_blk
            x_blk = x_blk + dt * vh
            a_blk = accel(x_blk)
            v_blk = vh + 0.5 * dt * a_blk
        energies.append(energy(x_blk, v_blk))
    if not energies:
        return x_blk, v_blk, x_blk.new_zeros((0,))
    return x_blk, v_blk, torch.stack(energies)
