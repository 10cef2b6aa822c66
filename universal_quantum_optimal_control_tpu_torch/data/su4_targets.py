r"""SU(4) target featurization: KAK (Cartan) decomposition, Weyl-chamber
canonicalization, the model's KAK input tokens and the ℤ₄ phase
representatives (port of the JAX package's ``data/su4_targets.py``).

Host numpy (complex128) only, as in the JAX package, which the port may not
import; this is its own copy.  The training-set builders (:func:`haar_su2`,
:func:`kak_targets`, :func:`random_global_phase`) draw from a
``numpy.random.Generator`` in the JAX package's order, so the same seed
gives the same arrays bit for bit.

Why the model needs them (JAX ``docs/two_qubit_results.md``): entanglement
fidelity is phase-invariant but the raw matrix featurization is not, so
inference runs the model on all four SU(4) ℤ₄ representatives of a gate
and keeps the best (:func:`z4_representatives`); and the shipped flagship
reads the full KAK featurization (:func:`kak_input_tokens`) because the map
from (A₁, A₂, c, B₁, B₂) to pulses is compositional where the map from raw
entries is not.
"""

from __future__ import annotations

import numpy as np

__all__ = ["haar_su2", "kak_targets", "random_global_phase",
           "z4_representatives", "kak_decompose", "kak_reconstruct",
           "kak_canonicalize", "kak_input_tokens"]

_X = np.array([[0, 1], [1, 0]], np.complex128)
_Y = np.array([[0, -1j], [1j, 0]], np.complex128)
_Z = np.array([[1, 0], [0, -1]], np.complex128)
_XX = np.kron(_X, _X)
_YY = np.kron(_Y, _Y)
_ZZ = np.kron(_Z, _Z)


def haar_su2(rng: np.random.Generator, n: int) -> np.ndarray:
    """``(n, 2, 2)`` Haar-random SU(2) via normalized quaternions."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([w + 1j * z, y + 1j * x], -1),
        np.stack([-y + 1j * x, w - 1j * z], -1)], -2)


def _cartan_exp(c: np.ndarray) -> np.ndarray:
    """``exp(−i(c₁·XX + c₂·YY + c₃·ZZ))`` for ``(n, 3)`` → ``(n, 4, 4)``.

    XX, YY, ZZ commute pairwise (the Cartan subalgebra is abelian) and are
    simultaneously diagonalized by the magic basis; here the closed form is
    assembled directly from the three commuting exponentials."""
    out = np.empty((c.shape[0], 4, 4), np.complex128)
    for i, (c1, c2, c3) in enumerate(c):
        w, v = np.linalg.eigh(c1 * _XX + c2 * _YY + c3 * _ZZ)
        out[i] = (v * np.exp(-1j * w)) @ v.conj().T
    return out


def kak_targets(rng: np.random.Generator, n: int,
                c_max: float = np.pi / 4,
                edge_frac: float = 0.0) -> np.ndarray:
    """``(n, 4, 4)`` SU(4) targets with uniform Weyl-chamber-box coverage:
    ``(A₁⊗A₂) · exp(−i Σ cₖ σₖσₖ) · (B₁⊗B₂)``, cₖ ~ U(0, c_max) sorted
    descending (c₁ ≥ c₂ ≥ c₃ ≥ 0), so the CZ/CNOT edge (π/4, 0, 0) and the
    iSWAP edge (π/4, π/4, 0) are neighbourhoods of positive density.

    ``edge_frac``: the fraction of samples whose Cartan coordinates are drawn
    from the U-shaped Beta(0.3, 0.3) instead, which puts mass at the
    chamber's corners and edges (iSWAP's corner needs two coordinates at
    the top and one at the bottom at once)."""
    c = rng.uniform(0.0, 1.0, size=(n, 3))
    n_edge = int(n * edge_frac)
    if n_edge:
        c[:n_edge] = rng.beta(0.3, 0.3, size=(n_edge, 3))
    c = np.sort(c * c_max, axis=1)[:, ::-1]
    A1, A2 = haar_su2(rng, n), haar_su2(rng, n)
    B1, B2 = haar_su2(rng, n), haar_su2(rng, n)
    core = _cartan_exp(c)
    kA = np.einsum("nab,ncd->nacbd", A1, A2).reshape(n, 4, 4)
    kB = np.einsum("nab,ncd->nacbd", B1, B2).reshape(n, 4, 4)
    return kA @ core @ kB


def random_global_phase(rng: np.random.Generator,
                        U: np.ndarray) -> np.ndarray:
    """Multiply each target by a random global phase e^{iθ}, θ ~ U(0, 2π):
    physics-neutral (the entanglement fidelity is phase-invariant), it
    teaches the raw-matrix featurization that invariance — the training
    side of :func:`z4_representatives`."""
    theta = rng.uniform(0.0, 2.0 * np.pi, size=U.shape[0])
    return U * np.exp(1j * theta)[:, None, None]


def z4_representatives(U: np.ndarray) -> np.ndarray:
    """The 4 SU(4) representatives of one gate: det-normalize, then the ℤ₄
    phases ``{1, i, −1, −i}`` (det c·U = c⁴·det U leaves a ℤ₄ ambiguity).
    ``(4, 4)`` complex → ``(4, 4, 4)``.  Inference-time canonicalization:
    run the model on all four, keep the best (two_qubit_eval --best_phase)."""
    U = np.asarray(U, np.complex128)
    c = np.linalg.det(U) ** (-0.25)
    return np.stack([c * U * p for p in (1.0, 1j, -1.0, -1j)])


# ---------------------------------------------------------------------------
# Full KAK (Cartan) decomposition — the SU(4) analog of the reference's
# YXY-Euler + SCORE featurization (universal_model.py:148-195: decompose the
# target into canonical coordinates + local factors, feed THOSE to the
# encoder).  Round-3 finding: raw-entry featurization underfits the
# inverse-KAK map (band-0 0.587 at 8192 mixed targets) — the map from
# (A₁, A₂, c, B₁, B₂) to pulses is compositional, the map from raw entries
# is not.
# ---------------------------------------------------------------------------

_QM = (1.0 / np.sqrt(2.0)) * np.array(
    [[1, 0, 0, 1j], [0, 1j, 1, 0], [0, 1j, -1, 0], [1, 0, 0, -1j]],
    dtype=np.complex128)
# diagonal sign patterns of XX/YY/ZZ in the magic basis (each is diagonal
# there); solved once for the θ → (c₀, c) linear map
_SIGS = np.stack([np.real(np.diag(_QM.conj().T @ np.kron(p, p) @ _QM))
                  for p in (_X, _Y, _Z)])  # (3, 4)
_THETA_TO_C = np.linalg.inv(
    np.concatenate([np.ones((1, 4)), _SIGS]).T)  # θ = [1ᵀ; sigs]ᵀ·[c0, -c]


def _so4_from_sym_unitary(m: np.ndarray):
    """Real orthogonal P (det +1) and angles θ with m = P·e^{2iθ}·Pᵀ for a
    complex symmetric unitary m.  Joint-diagonalizes Re(m), Im(m) (they
    commute) via a generic real combination, with a degeneracy-safe retry."""
    mr, mi = m.real, m.imag
    rng = np.random.default_rng(0)
    best = None
    for _ in range(16):
        t = rng.normal()
        w, P = np.linalg.eigh(mr + t * mi)
        D = P.T @ m @ P
        off = np.abs(D - np.diag(np.diag(D))).max()
        if best is None or off < best[0]:
            best = (off, P, D)
        if off < 1e-9:
            break
    off, P, D = best
    # f32-sourced inputs satisfy the [Re m, Im m] commutation only to ~1e-6;
    # accept the best generic combination at that scale (the residue lands
    # in the reconstruction error, which the tests bound)
    if off > 1e-4:
        raise np.linalg.LinAlgError(
            f"joint diagonalization failed (residual {off:.1e})")
    if np.linalg.det(P) < 0:
        P[:, 0] = -P[:, 0]
        D = P.T @ m @ P
    theta = np.angle(np.diag(D)) / 2.0
    return P, theta


def _split_local(K: np.ndarray):
    """SU(2)⊗SU(2) ← a 4×4 tensor-product unitary (nearest factorization)."""
    # reshape to (2,2,2,2) and take the dominant rank-1 factor of the
    # (A ⊗ B)[ac, bd] = A[a,b]·B[c,d] rearrangement
    T = K.reshape(2, 2, 2, 2).transpose(0, 2, 1, 3).reshape(4, 4)
    u, s, vh = np.linalg.svd(T)
    A = u[:, 0].reshape(2, 2) * np.sqrt(s[0])
    B = vh[0].reshape(2, 2) * np.sqrt(s[0])
    # normalize each into SU(2) (unit determinant; residual phase returned)
    dA = np.linalg.det(A)
    A = A / np.sqrt(dA)
    B = B * np.sqrt(dA)  # keep A⊗B equal to K up to the SU(2) convention
    dB = np.linalg.det(B)
    B = B / np.sqrt(dB)
    return A, B, np.sqrt(dB)


def kak_decompose(U: np.ndarray, canonicalize: bool = True):
    """Cartan decomposition of a 4×4 unitary (host numpy, float64):

        U = g · (A₁ ⊗ A₂) · exp(−i(c₁·XX + c₂·YY + c₃·ZZ)) · (B₁ ⊗ B₂)

    with A, B ∈ SU(2) and ``g`` a global phase.  Returns
    ``(A1, A2, c (3,), B1, B2, g)``.  ``canonicalize`` (default) steers the
    result through :func:`kak_canonicalize` so locally-similar targets get
    consistent features (the raw branch choice is measured to flatline
    training — module banner).  Verified by reconstruction in tests."""
    U = np.asarray(U, np.complex128)
    U = U * np.linalg.det(U) ** (-0.25)           # into SU(4) (ℤ₄ choice)
    M = _QM.conj().T @ U @ _QM
    m = M.T @ M
    P, theta = _so4_from_sym_unitary(m)
    # K2 = Pᵀ, K1 = M·P·e^{−iθ}; force det K1 = +1 by θ-shift if needed
    K1 = M @ P @ np.diag(np.exp(-1j * theta))
    if np.real(np.linalg.det(K1)) < 0:            # det K1 = e^{-iΣθ}·det(MP)
        theta[0] += np.pi
        K1 = M @ P @ np.diag(np.exp(-1j * theta))
    K1 = np.real(K1)                               # orthogonal by theory
    c0_c = _THETA_TO_C @ theta                     # [c0, -c1, -c2, -c3]
    c = -c0_c[1:]
    g = np.exp(1j * c0_c[0])
    L = _QM @ K1 @ _QM.conj().T                    # A₁⊗A₂ (up to phase in g)
    R = _QM @ P.T @ _QM.conj().T                   # B₁⊗B₂
    A1, A2, ga = _split_local(L)
    B1, B2, gb = _split_local(R)
    out = (A1, A2, c, B1, B2, g * ga * gb)
    if canonicalize:
        out = kak_canonicalize(*out)
    return out


def kak_reconstruct(A1, A2, c, B1, B2, g=1.0) -> np.ndarray:
    core = _cartan_exp(np.asarray(c, np.float64)[None])[0]
    return g * np.kron(A1, A2) @ core @ np.kron(B1, B2)


def kak_input_tokens(U_batch: np.ndarray) -> np.ndarray:
    """Featurize targets for the pulse model: ``(B, 4, 4)`` complex →
    ``(B, 9, 8)`` float32 tokens — 4 raw-row tokens (interleaved re/im,
    matching ``models.two_qubit.unitary_tokens``) + A₁/A₂/B₁/B₂ tokens
    (each local's 4 entries interleaved) + a Cartan token
    ``(c₁, c₂, c₃, Re g, Im g, 0, 0, 0)``.  Host-side preprocessing, like
    the reference's SCORE embedding stack."""
    out = np.zeros((len(U_batch), 9, 8), np.float32)
    for i, U in enumerate(np.asarray(U_batch, np.complex128)):
        A1, A2, c, B1, B2, g = kak_decompose(U)
        rows = np.stack([U.real, U.imag], -1).reshape(4, 8)
        out[i, :4] = rows
        for j, loc in enumerate((A1, A2, B1, B2)):
            out[i, 4 + j] = np.stack([loc.real, loc.imag], -1).reshape(8)
        out[i, 8, :5] = [c[0], c[1], c[2], g.real, g.imag]
    return out


# ---------------------------------------------------------------------------
# Weyl-chamber canonicalization.  kak_decompose's raw output is branch-
# dependent (θ permutations/shifts land in the locals), so locally-similar
# targets get scattered, DISCONTINUOUS features — measured to flatline
# training (kak_tokens run, band-0 0.488 vs 0.587 raw-entry).  Each move
# below preserves U exactly while steering c into a consistent form:
#   shift:  E(c) = E(c − nπ/2·e_k) · (−i)^n (σ_k⊗σ_k)^{n mod 2}
#   swap:   conjugating both qubits by R = exp(−iπ/4 σ_l) swaps c_j ↔ c_k
#   flip2:  conjugating by (σ_l ⊗ I) negates c_j and c_k (j, k ≠ l)
# with every absorbed factor kept in SU(2) via iσ and the phases in g.
# ---------------------------------------------------------------------------

_PAULIS = (_X, _Y, _Z)
_OTHER = {(0, 1): 2, (1, 2): 0, (0, 2): 1, (1, 0): 2, (2, 1): 0, (2, 0): 1}


def _rot(l):
    """R = exp(−iπ/4 σ_l) ∈ SU(2): R σ_j R† = σ_k, R σ_k R† = −σ_j for the
    cyclically-next pair (j, k) around axis l; σ_l fixed."""
    return (np.cos(np.pi / 4) * np.eye(2)
            - 1j * np.sin(np.pi / 4) * _PAULIS[l]).astype(np.complex128)


def kak_canonicalize(A1, A2, c, B1, B2, g):
    """Steer a valid decomposition into a consistent near-chamber form:
    every cₖ ∈ (−π/4, π/4], |c| sorted descending, at most one negative
    entry and only in the last (smallest-|c|) slot.  Locals stay SU(2);
    phases accumulate in ``g``; reconstruction exact (tested)."""
    A1 = np.array(A1, np.complex128)
    A2 = np.array(A2, np.complex128)
    B1 = np.array(B1, np.complex128)
    B2 = np.array(B2, np.complex128)
    c = np.array(c, np.float64)
    g = complex(g)

    # 1. shift every c_k into (−π/4, π/4]
    for k in range(3):
        n = int(np.ceil(c[k] / (np.pi / 2) - 0.5 - 1e-12))
        if n:
            c[k] -= n * np.pi / 2
            g *= (-1j) ** (n % 4)
            if n % 2:                       # absorb σ_k⊗σ_k = −(iσ_k)⊗(iσ_k)
                g *= -1.0
                B1 = (1j * _PAULIS[k]) @ B1
                B2 = (1j * _PAULIS[k]) @ B2

    def swap(j, k):
        nonlocal A1, A2, B1, B2, c
        R = _rot(_OTHER[(j, k)])
        # R maps one of (σ_j, σ_k) to the other up to signs that cancel in
        # σ⊗σ; conjugating E by (R⊗R) swaps c_j ↔ c_k exactly
        A1 = A1 @ R.conj().T
        A2 = A2 @ R.conj().T
        B1 = R @ B1
        B2 = R @ B2
        c[j], c[k] = c[k], c[j]

    def flip2(j, k):
        nonlocal A1, B1, g, c
        l = _OTHER[(j, k)]
        P_ = 1j * _PAULIS[l]
        A1 = A1 @ P_
        B1 = P_ @ B1
        g = -g
        c[j] = -c[j]
        c[k] = -c[k]

    # 2. |c| descending via swaps
    order = np.argsort(-np.abs(c), kind="stable")
    if order[0] != 0:
        swap(0, int(order[0]))
        order = np.argsort(-np.abs(c), kind="stable")
    if order[1] != 1:
        swap(1, 2)

    # 3. at most one negative, pushed to the last slot
    neg = [k for k in range(3) if c[k] < -1e-15]
    if len(neg) >= 2:
        flip2(neg[0], neg[1])
        neg = [k for k in range(3) if c[k] < -1e-15]
    if len(neg) == 1 and neg[0] != 2:
        flip2(neg[0], 2)
    return A1, A2, c, B1, B2, g
