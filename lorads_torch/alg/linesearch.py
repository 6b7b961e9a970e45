"""Exact ALM line search: quartic minimization via closed-form cubic roots.

Port of lorads_tpu/alg/linesearch.py (reference LORADScubic_equation and
ALMLineSearch, lorads_alm.c:114-228).  Everything stays on the
coefficients' device, as in lorads_tpu: the quartic's coefficients
(dot products of device vectors), the closed-form cubic (a chain of
torch ops) and the selection of tau (a ``torch.where`` chain), so the
ALM inner loop can run in graphed chunks with no host read per step.
"""

from __future__ import annotations

import math

import torch


def _nthroot3(x):
    """Signed cube root (reference LORADSnthroot, lorads_alm.c:102-112)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def cubic_roots(a, b, c, d):
    """Roots of a*x^3 + b*x^2 + c*x + d = 0, Shengjin's formulas.

    Returns (roots[3], num_roots) exactly mirroring the reference's
    case split; invalid slots hold 0.0.  num_roots == 0 flags the
    degenerate case the reference treats as a numerical error.
    Works elementwise on tensors of any (equal) shape.
    """
    w = torch.where
    A = b * b - 3.0 * a * c
    B = b * c - 9.0 * a * d
    C = c * c - 3.0 * b * d
    delta = B * B - 4.0 * A * C

    case1 = (A == 0.0) & (B == 0.0)
    case_d_pos = (~case1) & (delta > 0.0)
    case_d_zero = (~case1) & (delta == 0.0) & (A != 0.0) & (B != 0.0)
    case_d_neg = (~case1) & (delta < 0.0)

    one = torch.ones_like(a)
    zero = torch.zeros_like(a)
    # case 1: triple/degenerate root -c/b, clamped at 0
    safe_b = w(b == 0.0, one, b)
    r1_case1 = torch.clamp(-c / safe_b, min=0.0)

    # delta > 0: one real root
    sq = torch.sqrt(torch.clamp(delta, min=0.0))
    Y1 = A * b + 1.5 * a * (-B + sq)
    Y2 = A * b + 1.5 * a * (-B - sq)
    safe_a = w(a == 0.0, one, a)
    r1_dpos = torch.clamp((-b - _nthroot3(Y1) - _nthroot3(Y2))
                          / (3.0 * safe_a), min=0.0)

    # delta == 0 (A, B nonzero): two roots
    safe_A = w(A == 0.0, one, A)
    K = B / safe_A
    r1_dz = -b / safe_a + K
    r2_dz = -K / 2.0

    # delta < 0: three real roots
    sqA = torch.sqrt(torch.clamp(A, min=0.0))
    safe_den = w(A * sqA == 0.0, one, A * sqA)
    T = torch.clamp((A * b - 1.5 * a * B) / safe_den, -1.0, 1.0)
    theta = torch.arccos(T)
    csth = torch.cos(theta / 3.0)
    sn3th = math.sqrt(3.0) * torch.sin(theta / 3.0)
    r1_dn = (-b - 2.0 * sqA * csth) / (3.0 * safe_a)
    r2_dn = (-b + sqA * (csth + sn3th)) / (3.0 * safe_a)
    r3_dn = (-b + sqA * (csth - sn3th)) / (3.0 * safe_a)

    root1 = w(case1, r1_case1,
              w(case_d_pos, r1_dpos,
                w(case_d_zero, r1_dz, w(case_d_neg, r1_dn, zero))))
    root2 = w(case_d_zero, r2_dz, w(case_d_neg, r2_dn, zero))
    root3 = w(case_d_neg, r3_dn, zero)

    i = lambda v: torch.full_like(a, v, dtype=torch.int64)
    num = w(case1 | case_d_pos, i(1),
            w(case_d_zero, i(2), w(case_d_neg, i(3), i(0))))
    return torch.stack([root1, root2, root3]), num


def _phi(a, b, c, d, x):
    return ((a * x + b) * x + c) * x * x + d * x


def quartic_coeffs(rho, lam, p1, p2, q0, q1, q2) -> torch.Tensor:
    """[a, b, c, d] of phi(tau) = a t^4 + b t^3 + c t^2 + d t on the
    inputs' device (ALMLineSearch, lorads_alm.c:161-228):
      q0 = b - A(RR^T) (pre lambda shift; shifted here),
      q1 = 2 A(sym(RD^T)), q2 = A(DD^T),
      p1 = 2 <C, sym(RD^T)>, p2 = <C, DD^T>."""
    q2n2 = torch.dot(q2, q2)
    a = rho * q2n2 / 2.0
    b = rho * torch.dot(q1, q2)
    q0s = q0 + lam / rho
    q1n2 = torch.dot(q1, q1)
    c = p2 - rho * torch.dot(q0s, q2) + rho * q1n2 / 2.0
    d = p1 - rho * torch.dot(q0s, q1)
    return torch.stack([a, b, c, d])


def line_search_from_coeffs(coeffs: torch.Tensor):
    """Minimize the quartic over tau in (0, 1] -> (tau, num_roots), 0-d
    tensors on coeffs' device; num_roots == 0 means a numerical
    error."""
    a, b, c, d = coeffs.to(torch.float64).unbind()
    # Normalize the derivative cubic by its largest coefficient before
    # the discriminant: roots are scale-invariant, and B^2 - 4AC on the
    # raw coefficients overflows f32 for rho-scaled problems.
    ca, cb, cc, cd = 4.0 * a, 3.0 * b, 2.0 * c, d
    scale = torch.maximum(torch.maximum(ca.abs(), cb.abs()),
                          torch.maximum(cc.abs(), cd.abs()))
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    roots, num = cubic_roots(ca / scale, cb / scale, cc / scale,
                             cd / scale)

    f0 = torch.zeros_like(a)
    f1 = _phi(a, b, c, d, 1.0)
    in_range = ((roots > 1e-20) & (roots <= 1.0)
                & (torch.arange(3, device=roots.device) < num))
    big = torch.full_like(roots, 1e30)
    froots = torch.where(in_range, _phi(a, b, c, d, roots), big)
    froots = torch.where(torch.isnan(froots), big, froots)

    min_f = torch.minimum(torch.minimum(f0, f1), torch.min(froots))
    # selection priority (last assignment wins in the reference):
    # roots[2] > roots[1] > roots[0] > tau=1 > tau=0
    tau = torch.where(torch.abs(min_f - f1) < 1e-10, 1.0, f0)
    for j in range(3):
        tau = torch.where(torch.abs(min_f - froots[j]) < 1e-10, roots[j],
                          tau)
    return tau, num


def alm_line_search(rho, lam, p1, p2, q0, q1, q2):
    """(tau, num_roots) of the exact ALM line search, 0-d tensors on the
    inputs' device; ``rho`` a number or a 0-d tensor."""
    return line_search_from_coeffs(
        quartic_coeffs(rho, lam, p1, p2, q0, q1, q2))
