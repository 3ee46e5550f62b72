"""1.5D processor-grid logic for the paper's Algorithm 4.

A copy of ``repro.comm.grid`` (the port imports nothing of ``repro``).
The machine is a flat ring of P processes organized as a 3-axis grid

    ("i", "j", "k")  with sizes  (P / (c_x * c_omega), c_omega, c_x)

which expresses BOTH logical grids of the paper at once:

  * X-like arrays (replication factor c_x; X, X^T, S, W in Cov):
      partitioned into n_x = P/c_x blocks indexed by t = i*c_omega + j,
      replicated along "k".   "X-team" t = the c_x processes (i, j, :).
  * Omega-like arrays (replication factor c_omega; Omega, Y, Z, G in Obs):
      partitioned into n_om = P/c_omega blocks indexed by u = i*c_x + k,
      replicated along "j".   "Omega-team" u = the c_omega processes (i, :, k).

Ring orderings: Algorithm 4 rotates the R operand around a ring whose teams
must be contiguous.  Two flat orderings of the same processes are used:

  * x-major flat:     f  = (i*c_omega + j)*c_x + k     (row-major (i,j,k))
    -> X-teams contiguous; used when the FIXED operand is X-like (Cov).
  * omega-major flat: f' = (i*c_x + k)*c_omega + j
    -> Omega-teams contiguous; used when the fixed operand is Omega-like (Obs).

A process's rank in the ``torch.distributed`` group IS its x-major flat
index, so every permutation below is a table of (source rank, destination
rank) pairs (``comm.group.Comm.ppermute``); omega-major rings are
converted.

The initial "shift by delta" of Algorithm 4 (staggering, so team members
hold distinct R blocks) is one arbitrary permutation: STAGGER.  At round r
of the rotation, the process at ring-flat position f holds R block
(f + r*shift) mod n_R, where shift = c_F (the fixed operand's replication).
"""
from __future__ import annotations

from dataclasses import dataclass

AXES = ("i", "j", "k")


@dataclass(frozen=True)
class Grid1p5D:
    n_devices: int          # P
    c_x: int                # replication factor of X-like arrays
    c_omega: int            # replication factor of Omega-like arrays

    def __post_init__(self):
        P, cx, co = self.n_devices, self.c_x, self.c_omega
        if cx < 1 or co < 1 or cx * co > P:
            raise ValueError(f"need 1 <= c_x*c_omega <= P, got {cx}*{co} > {P}")
        if P % (cx * co) != 0:
            raise ValueError(f"c_x*c_omega={cx*co} must divide P={P}")

    # -- sizes ---------------------------------------------------------
    @property
    def n_i(self) -> int:
        return self.n_devices // (self.c_x * self.c_omega)

    @property
    def n_x(self) -> int:
        """Number of X-like blocks (P / c_x)."""
        return self.n_devices // self.c_x

    @property
    def n_om(self) -> int:
        """Number of Omega-like blocks (P / c_omega)."""
        return self.n_devices // self.c_omega

    @property
    def rounds(self) -> int:
        """Rotation rounds of Algorithm 4: P / (c_x * c_omega)."""
        return self.n_devices // (self.c_x * self.c_omega)

    def mesh_shape(self) -> tuple[int, int, int]:
        return (self.n_i, self.c_omega, self.c_x)

    # -- flat-index conversions (all return x-major flat rank) ----------
    def coords_to_flat(self, i: int, j: int, k: int) -> int:
        return (i * self.c_omega + j) * self.c_x + k

    def flat_to_coords(self, f: int) -> tuple[int, int, int]:
        k = f % self.c_x
        t = f // self.c_x
        return t // self.c_omega, t % self.c_omega, k

    def omajor_to_flat(self, fo: int) -> int:
        """omega-major ring position -> x-major flat rank."""
        j = fo % self.c_omega
        u = fo // self.c_omega
        i, k = u // self.c_x, u % self.c_x
        return self.coords_to_flat(i, j, k)

    def flat_to_omajor(self, f: int) -> int:
        i, j, k = self.flat_to_coords(f)
        return (i * self.c_x + k) * self.c_omega + j

    # -- permutations (x-major flat (src, dst) pairs) ----------------------
    def stagger_perm(self, canonical: str, ring: str, n_r: int) -> list[tuple[int, int]]:
        """Initial 'shift by delta' (Alg. 4 lines 2-3): move R from its
        canonical replicated layout to the staggered rotation layout where
        ring position f holds block (f mod n_r).

        canonical: layout R is stored in — "xlike" (block t=i*c_om+j,
        replica index k) or "omegalike" (block u=i*c_x+k, replica index j).
        ring: "x" or "omega" — which flat ordering the rotation uses.
        """
        perm = []
        for f in range(self.n_devices):
            i, j, k = self.flat_to_coords(f)
            if canonical == "xlike":
                block, rep = i * self.c_omega + j, k
            elif canonical == "omegalike":
                block, rep = i * self.c_x + k, j
            else:
                raise ValueError(canonical)
            # replica `rep` of block `block` serves ring slot block + rep*n_r
            dst_ring = block + rep * n_r
            dst = dst_ring if ring == "x" else self.omajor_to_flat(dst_ring)
            perm.append((f, dst))
        self._check_perm(perm)
        return perm

    def shift_perm(self, ring: str, shift: int) -> list[tuple[int, int]]:
        """One rotation step: ring position f receives from f+shift
        (equivalently: src s sends to (s - shift) mod P in ring order)."""
        P = self.n_devices
        perm = []
        for s_ring in range(P):
            d_ring = (s_ring - shift) % P
            if ring == "x":
                perm.append((s_ring, d_ring))
            else:
                perm.append((self.omajor_to_flat(s_ring), self.omajor_to_flat(d_ring)))
        self._check_perm(perm)
        return perm

    @staticmethod
    def _check_perm(perm):
        srcs = {s for s, _ in perm}
        dsts = {d for _, d in perm}
        if len(srcs) != len(perm) or len(dsts) != len(perm):
            raise ValueError("not a permutation")

    # -- padding helper --------------------------------------------------
    def pad_p(self, p: int) -> int:
        """Smallest p' >= p divisible by P.

        p % P == 0 guarantees every layout constraint at once: n_x | p,
        n_om | p, and the per-block sub-slicing of the replication-aware
        transposes (blk_x % c_x == 0, blk_om % c_omega == 0)."""
        m = self.n_devices
        return ((p + m - 1) // m) * m


def best_grid(P: int, p: int, n: int, d: float, *, variant: str,
              machine=None, s_iters: int = 30, t_ls: float = 10.0) -> Grid1p5D:
    """Pick (c_x, c_omega) for a problem with the paper's cost model
    (``core.costmodel``, the port's H100 constants by default); Cov
    additionally requires c_x**2 | P (the X^T X rotation has
    c_R = c_F = c_x)."""
    from ..core.costmodel import H100, ProblemShape, cov_costs, obs_costs

    m = machine or H100
    shape = ProblemShape(p=p, n=n, d=d, s=s_iters, t=t_ls)
    best, best_t = None, float("inf")
    c = 1
    cands = []
    while c <= P:
        cands.append(c)
        c *= 2
    for cx in cands:
        for co in cands:
            if cx * co > P or P % (cx * co):
                continue
            if variant == "cov" and (P % (cx * cx) or co != cx):
                # driver keeps Omega in X-like layout between iterations
                continue
            fn = cov_costs if variant == "cov" else obs_costs
            cb = fn(shape, P, cx, co, m)
            if cb.mem_words * m.word_bytes > m.hbm_bytes * P:
                continue
            if cb.total < best_t:
                best, best_t = (cx, co), cb.total
    if best is None:
        raise ValueError(f"no feasible grid for P={P}, p={p}")
    return Grid1p5D(P, best[0], best[1])
