"""Host-side (exact Python int) elliptic curve arithmetic.

The protocol layer does a handful of one-off group ops (keygen, adaptor
signature algebra, proof assembly); those run here.  The bulk ops (MSM,
per-block encryption, in-circuit scalar muls) run on the device classes in
`edwards.py` / `weierstrass.py`, which are cross-checked against these.

Twisted Edwards: a*x^2 + y^2 = 1 + d*x^2*y^2  (Jubjub: a = -1)
Short Weierstrass: y^2 = x^3 + a*x + b over Fp or Fp2.
"""

from __future__ import annotations

from dataclasses import dataclass


# ------------------------------------------------------------ twisted Edwards
@dataclass(frozen=True)
class EdwardsCurve:
    p: int  # base field
    a: int
    d: int
    order: int  # prime subgroup order
    cofactor: int
    gx: int
    gy: int

    def is_on_curve(self, P):
        x, y = P
        return (self.a * x * x + y * y - 1 - self.d * x * x * y * y) % self.p == 0

    def add(self, P, Q):
        # complete affine addition (d non-square => denominators non-zero)
        p, a, d = self.p, self.a, self.d
        x1, y1 = P
        x2, y2 = Q
        dxy = d * x1 * x2 * y1 * y2 % p
        x3 = (x1 * y2 + y1 * x2) * pow(1 + dxy, -1, p) % p
        y3 = (y1 * y2 - a * x1 * x2) * pow(1 - dxy, -1, p) % p
        return (x3, y3)

    def neg(self, P):
        return ((-P[0]) % self.p, P[1])

    def mul(self, k: int, P):
        R = (0, 1)
        Q = P
        while k > 0:
            if k & 1:
                R = self.add(R, Q)
            Q = self.add(Q, Q)
            k >>= 1
        return R

    @property
    def generator(self):
        return (self.gx, self.gy)

    def solve_x(self, y: int, x_is_larger: bool):
        """Recover x from y (point decompression): x^2 = (y^2-1)/(d*y^2-a)."""
        p = self.p
        num = (y * y - 1) % p
        den = (self.d * y * y - self.a) % p
        x2 = num * pow(den, -1, p) % p
        x = sqrt_mod(x2, p)
        if x is None:
            return None
        if (x > p - x) != x_is_larger:
            x = (p - x) % p
        return x


# --------------------------------------------------------- short Weierstrass
@dataclass(frozen=True)
class SWCurve:
    p: int
    a: int
    b: int
    order: int
    gx: int
    gy: int

    def is_on_curve(self, P):
        if P is None:
            return True
        x, y = P
        return (y * y - x * x * x - self.a * x - self.b) % self.p == 0

    def add(self, P, Q):
        if P is None:
            return Q
        if Q is None:
            return P
        p = self.p
        x1, y1 = P
        x2, y2 = Q
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            lam = (3 * x1 * x1 + self.a) * pow(2 * y1, -1, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
        x3 = (lam * lam - x1 - x2) % p
        y3 = (lam * (x1 - x3) - y1) % p
        return (x3, y3)

    def neg(self, P):
        if P is None:
            return None
        return (P[0], (-P[1]) % self.p)

    def mul(self, k: int, P):
        """k P (None for k <= 0): double-and-add in Jacobian coordinates,
        one inversion at the end instead of one per step; the same affine
        point as the affine ladder."""
        if P is None or k <= 0:
            return None
        p = self.p
        x, y = P
        J = None
        for bit in bin(k)[2:]:
            J = self._jdouble(J)
            if bit == "1":
                J = self._jadd_affine(J, x, y)
        if J is None:
            return None
        X, Y, Z = J
        zi = pow(Z, -1, p)
        zi2 = zi * zi % p
        return (X * zi2 % p, Y * zi2 * zi % p)

    def _jdouble(self, J):
        """2 J for a Jacobian point (x = X/Z^2, y = Y/Z^3; None the identity)."""
        if J is None:
            return None
        p = self.p
        X, Y, Z = J
        if Y == 0:
            return None
        YY = Y * Y % p
        S = 4 * X * YY % p
        M = 3 * X * X
        if self.a:
            M += self.a * pow(Z, 4, p)
        M %= p
        X3 = (M * M - 2 * S) % p
        return (X3, (M * (S - X3) - 8 * YY * YY) % p, 2 * Y * Z % p)

    def _jadd_affine(self, J, x2: int, y2: int):
        """J + (x2, y2) for a Jacobian J and an affine point."""
        if J is None:
            return (x2, y2, 1)
        p = self.p
        X1, Y1, Z1 = J
        Z1Z1 = Z1 * Z1 % p
        H = (x2 * Z1Z1 - X1) % p
        r = (y2 * Z1 * Z1Z1 - Y1) % p
        if H == 0:
            return self._jdouble(J) if r == 0 else None
        HH = H * H % p
        HHH = H * HH % p
        V = X1 * HH % p
        X3 = (r * r - HHH - 2 * V) % p
        return (X3, (r * (V - X3) - Y1 * HHH) % p, Z1 * H % p)

    @property
    def generator(self):
        return (self.gx, self.gy)


# ------------------------------------------------------------------- helpers
def sqrt_mod(a: int, p: int):
    """Tonelli-Shanks; returns a square root of a mod p or None."""
    a %= p
    if a == 0:
        return 0
    if p % 4 == 3:
        # one exponentiation: the candidate squares back to a exactly when
        # a is a residue (the Euler test is a second one, and decompressing
        # a large verifying key spends its time here)
        r = pow(a, (p + 1) // 4, p)
        return r if r * r % p == a else None
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    # general Tonelli-Shanks
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        bexp = pow(c, 1 << (m - i - 1), p)
        m, c = i, bexp * bexp % p
        t = t * c % p
        r = r * bexp % p
    return r
