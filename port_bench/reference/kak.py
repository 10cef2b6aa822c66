"""KAK input tokens of two-qubit targets, host NumPy (complex128).

The model of ``two_qubit_d2_kak`` reads each target as 9 tokens of 8:
its 4 rows (interleaved re/im), the 4 local SU(2) factors of its Cartan
decomposition ``U = g·(A₁⊗A₂)·exp(−i(c₁XX + c₂YY + c₃ZZ))·(B₁⊗B₂)`` and a
token ``(c₁, c₂, c₃, Re g, Im g, 0, 0, 0)``, with the decomposition steered
into a canonical near-chamber form (c sorted by magnitude, each in
(−π/4, π/4], at most one negative and only the last).  A frozen copy of the
published featurization, so that the benchmark derives the tokens again
from the targets it made.
"""

import numpy as np

_X = np.array([[0, 1], [1, 0]], np.complex128)
_Y = np.array([[0, -1j], [1j, 0]], np.complex128)
_Z = np.array([[1, 0], [0, -1]], np.complex128)
_XX = np.kron(_X, _X)
_YY = np.kron(_Y, _Y)
_ZZ = np.kron(_Z, _Z)


def cartan_exp(c: np.ndarray) -> np.ndarray:
    """``exp(−i(c₁·XX + c₂·YY + c₃·ZZ))`` for ``(n, 3)`` → ``(n, 4, 4)``.

    XX, YY, ZZ commute pairwise (the Cartan subalgebra is abelian) and are
    simultaneously diagonalized by the magic basis; here the closed form is
    assembled directly from the three commuting exponentials."""
    out = np.empty((c.shape[0], 4, 4), np.complex128)
    for i, (c1, c2, c3) in enumerate(c):
        w, v = np.linalg.eigh(c1 * _XX + c2 * _YY + c3 * _ZZ)
        out[i] = (v * np.exp(-1j * w)) @ v.conj().T
    return out


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
