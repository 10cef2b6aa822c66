r"""Bloch-sphere ensemble evolution: simulation and animation (port of the
JAX package's ``analysis/bloch.py``).

The Bloch vector of ``U|0⟩`` is the rotated z-axis ``R(q)·ẑ``, where R is
the SO(3) matrix of the propagator quaternion.  :func:`bloch_trajectories`
forms the running product segment by segment in plain PyTorch (no kernel
computes prefix products, and the ensembles are tiny: 12 samples × L).
Each segment is built by the same P-dispatching function the propagator
uses (``core/propagate.py``), so at every P — ``(φ, τ)``, ``(φ, Ω, τ)``,
``(φ, Ω, Δ, τ)`` — a trajectory ends at the propagator's ``R(q)·ẑ``; the
JAX package builds every segment from the first two columns as ``(φ, τ)``,
which at P = 4 reads Ω as τ and drops Δ (``ROADMAP.md`` §C).  The
animation's E[F] goes through kernel B3 on CUDA, and its clock reads τ
from the last column.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core import su2
from ..core.errors import sample_ore_ple
from ..core.propagate import _segment_quats
from ..utils.device import resolve_device
from .plots import _as_pulses, _as_target_quat, _mc_stats, _pyplot

__all__ = ["quat_rotation_matrix", "bloch_trajectories", "spinor_to_bloch",
           "animate_bloch_ensemble"]


def quat_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """SO(3) matrix ``(..., 3, 3)`` of the conjugation ``v ↦ U v U†`` by
    ``U(q)``: for U = exp(−iθ/2 n·σ), the rotation by θ about n."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def spinor_to_bloch(psi: torch.Tensor) -> torch.Tensor:
    """``(..., 2)`` complex spinors → ``(..., 3)`` Bloch vectors."""
    a, b = psi[..., 0], psi[..., 1]
    ab = torch.conj(a) * b
    return torch.stack([2 * ab.real, 2 * ab.imag, a.abs() ** 2 - b.abs() ** 2], dim=-1)


def _trajectories(pulses: torch.Tensor, delta: torch.Tensor, eps: torch.Tensor,
                  r0: torch.Tensor) -> torch.Tensor:
    """Cumulative per-segment Bloch vectors ``(S, L + 1, 3)`` of ``(L, P)``
    pulses under ``(S,)`` disorder samples."""
    q = su2.quat_identity(delta.shape, dtype=pulses.dtype, device=pulses.device)
    qs = [q]
    for k in range(pulses.shape[0]):
        q = su2.quat_multiply(_segment_quats(pulses[k:k + 1], delta, eps)[:, 0], q)
        qs.append(q)
    return quat_rotation_matrix(torch.stack(qs, dim=1)) @ r0


def bloch_trajectories(pulses, delta, eps,
                       r0: Tuple[float, float, float] = (0.0, 0.0, 1.0),
                       device=None) -> np.ndarray:
    """Bloch trajectories of the state ``r0`` under ``(L, P)`` pulses for
    ``(S,)`` disorder samples: ``(S, L + 1, 3)`` numpy Bloch vectors (step 0
    is ``r0``)."""
    dev = resolve_device(device)
    p = _as_pulses(pulses, dev)
    d = torch.as_tensor(delta, dtype=p.dtype, device=dev)
    e = torch.as_tensor(eps, dtype=p.dtype, device=dev)
    with torch.no_grad():
        r = _trajectories(p, d, e, torch.as_tensor(r0, dtype=p.dtype, device=dev))
    return r.cpu().numpy()


def animate_bloch_ensemble(pulses, u_target=None, delta_std: float = 0.5,
                           epsilon_std: float = 0.05, n_samples: int = 16,
                           save_path: Optional[str] = None, fps: int = 15,
                           title: str = "",
                           generator: Optional[torch.Generator] = None, device=None):
    """Animate the disorder ensemble on a matplotlib 3D Bloch sphere with a
    running time and E[F] title.  Saves an mp4 through ffmpeg, else a gif
    through Pillow, and returns the path written (the animation where
    ``save_path`` is None).  ``generator`` defaults to one seeded with 0 on
    ``device``."""
    plt = _pyplot()
    from matplotlib import animation

    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    delta, eps = sample_ore_ple(generator, (n_samples,), delta_std, epsilon_std)
    traj = bloch_trajectories(pulses, delta, eps, device=dev)  # (S, L+1, 3)
    t_cum = np.concatenate([[0.0], np.cumsum(np.asarray(pulses)[:, -1])])

    mean_fid = None
    if u_target is not None:
        with torch.no_grad():
            mean_fid = float(_mc_stats(_as_pulses(pulses, dev),
                                       _as_target_quat(u_target, dev), delta, eps)[0])

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")

    def draw_sphere():
        u = np.linspace(0, 2 * np.pi, 40)
        v = np.linspace(0, np.pi, 20)
        xs = np.outer(np.cos(u), np.sin(v))
        ys = np.outer(np.sin(u), np.sin(v))
        zs = np.outer(np.ones_like(u), np.cos(v))
        ax.plot_wireframe(xs, ys, zs, color="lightgray", linewidth=0.3, alpha=0.5)
        for axis, lbl in zip(np.eye(3), ["x", "y", "z"]):
            ax.quiver(0, 0, 0, *axis, color="gray", arrow_length_ratio=0.08, linewidth=0.8)
            ax.text(*(axis * 1.25), lbl)
        ax.set_xlim(-1.1, 1.1)
        ax.set_ylim(-1.1, 1.1)
        ax.set_zlim(-1.1, 1.1)
        ax.set_axis_off()

    def update(frame):
        ax.clear()
        draw_sphere()
        for s in range(traj.shape[0]):
            ax.plot(traj[s, :frame + 1, 0], traj[s, :frame + 1, 1], traj[s, :frame + 1, 2],
                    lw=0.7, alpha=0.6)
            ax.scatter(*traj[s, frame], s=10)
        extra = f", E[F] = {mean_fid:.4f}" if mean_fid is not None else ""
        ax.set_title(f"{title} t = {t_cum[frame] / np.pi:.2f}π{extra}")
        return []

    anim = animation.FuncAnimation(fig, update, frames=traj.shape[1], blit=False)
    if save_path is None:
        return anim
    try:
        anim.save(save_path, writer=animation.FFMpegWriter(fps=fps))
        saved_path = str(save_path)
    except (FileNotFoundError, RuntimeError):
        saved_path = str(save_path).rsplit(".", 1)[0] + ".gif"
        anim.save(saved_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return saved_path
