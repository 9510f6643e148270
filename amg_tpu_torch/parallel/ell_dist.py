"""Distributed unstructured (ELL) multigrid: row-partitioned V-cycles for
banded hierarchies, the reference's flat 1-D interpolation pipeline
(interpolator.hpp:98-142) included.

PyTorch port of ``amg_tpu/parallel/ell_dist.py``, in plain PyTorch as JAX
runs it in plain XLA. Every level operator is an ELL matrix whose rows are
cut into D equal slabs. For a banded matrix under contiguous row slabs
(the reference's lexicographic dof order, grid.hpp:88-98) every column a
slab's rows reference lies in ``[block_start - W, block_end + W)`` for a
small host-computed W, so an op needs one exchange of W-wide boundary
slices. Columns are rewritten at setup to window coordinates
(col - owner block start + W), and the per-slab gather ``x_ext[cols]``
is one ``torch.gather`` over the (D, B_x + 2W) windows.

As in structured_dist.py the mesh is a leading slab axis (a level costs
the same launches for any D), and the slabs are cut into blocks of D/P
consecutive slabs, over the cards of one process (a card group, a thread
a block) or over the processes of a process group, the exchanges, sums
and gathers going through parallel/launch.py.

Levels stay sharded while their window fits the block (W <= B and
B >= min_rows); the deeper ones are agglomerated: the coarse rhs is
gathered and the remaining sub-hierarchy runs replicated (multigrid.py's
``build_hierarchy`` and ``vcycle``, MulticolorGaussSeidel), down to the
dense-LU coarsest solve (multigrid.hpp:240-243).
"""

from __future__ import annotations

import copy
import dataclasses
from types import SimpleNamespace

import numpy as np
import scipy.sparse as sp
import torch

from amg_tpu_torch.krylov import _step
from amg_tpu_torch.multigrid import SolveResult, build_hierarchy, vcycle
from amg_tpu_torch.ops.kernels import graph_loop
from amg_tpu_torch.ops.doublefloat import (DF32, df_add, df_add_f32, df_mul,
                                           df_neg, df_rss)
from amg_tpu_torch.ops.smoothers import MulticolorGaussSeidel
from amg_tpu_torch.ops.transfer import LinearInterpolator
from amg_tpu_torch.parallel import launch
from amg_tpu_torch.sparse.ell import ELL
from amg_tpu_torch.utils.coloring import greedy_coloring
from amg_tpu_torch.utils.debugging import check_rss
from amg_tpu_torch.utils.device import resolve_device

HALO_MODES = ("strips", "step")


# ---------------------------------------------------------------------------
# Host setup: padded, windowed ELL slabs


def _pad_rows_csr(M, rows_pad: int, cols_pad: int):
    """A scipy CSR padded to rows_pad rows on the padded column space
    [0, cols_pad): identity rows on the padding when the operator is
    square (padded vector entries stay exactly zero through smoothing,
    matvec and rss), zero rows otherwise."""
    M = M.tocsr()
    n_rows, n_cols = M.shape
    M = sp.csr_matrix((M.data, M.indices, M.indptr), shape=(n_rows,
                                                            cols_pad))
    if n_rows == n_cols:
        eye_rows = np.arange(n_rows, rows_pad)
        pad = sp.coo_matrix(
            (np.ones(len(eye_rows)), (eye_rows - n_rows, eye_rows)),
            shape=(rows_pad - n_rows, cols_pad))
    else:
        pad = sp.csr_matrix((rows_pad - n_rows, cols_pad))
    Mp = sp.vstack([M, pad]).tocsr()
    Mp.sort_indices()
    return Mp


def _ell_arrays(Mp):
    """(data, cols) (rows, K) numpy arrays of a CSR, zero-filled slots."""
    rows = Mp.shape[0]
    deg = np.diff(Mp.indptr)
    K = max(int(deg.max()), 1)
    data = np.zeros((rows, K))
    cols = np.zeros((rows, K), dtype=np.int64)
    rows_of = np.repeat(np.arange(rows), deg)
    pos = np.arange(Mp.nnz) - np.repeat(Mp.indptr[:-1], deg)
    data[rows_of, pos] = Mp.data
    cols[rows_of, pos] = Mp.indices
    return data, cols


@dataclasses.dataclass(frozen=True)
class ShardedOp:
    """A row-partitioned ELL operator in window coordinates.

    data, cols: (D, B_row, K) tensors (numpy from ``build(as_numpy=True)``);
    B_row: rows a slab; B_x: a slab's block of the input vector x; W: the
    halo width each side of the block.
    """

    data: object
    cols: object
    B_row: int
    B_x: int
    W: int

    @staticmethod
    def build(M, D: int, B_row: int, B_x: int, dtype=torch.float64,
              as_numpy: bool = False, device=None) -> "ShardedOp":
        """M: scipy CSR (n_rows x n_cols). Rows padded to D*B_row with
        identity rows when square or zero rows otherwise; padding slots
        point at the owner's block start; columns rewritten to window
        coordinates. ``as_numpy``: the host f64 values (df32 splitting
        keeps full precision); else tensors on ``device`` (None:
        ``"cuda"``)."""
        Mp = _pad_rows_csr(M, D * B_row, D * B_x)
        rows_pad = Mp.shape[0]
        data, colsg = _ell_arrays(Mp)
        owner = (np.arange(rows_pad) // B_row)[:, None]
        colsg = np.where(data == 0, owner * B_x, colsg)
        # the window: the farthest any referenced column lies outside the
        # owner's [0, B_x) block
        rel = colsg - owner * B_x
        W = int(max(1, np.max(np.maximum(-rel, rel - (B_x - 1)))))
        cols = rel + W
        assert cols.min() >= 0 and cols.max() < B_x + 2 * W
        K = data.shape[1]
        data, cols = data.reshape(D, B_row, K), cols.reshape(D, B_row, K)
        if not as_numpy:
            device = resolve_device(device)
            data = torch.tensor(data, dtype=dtype, device=device)
            cols = torch.tensor(cols, device=device)
        return ShardedOp(data=data, cols=cols, B_row=B_row, B_x=B_x, W=W)

    def local(self, mesh: launch.SlabMesh, device) -> "ShardedOp":
        """This block's slabs, on ``device``."""
        return dataclasses.replace(self,
                                   data=mesh.local(self.data).to(device),
                                   cols=mesh.local(self.cols).to(device))


def build_ext_panels(M, colors_pad, diag_pad, D: int, B: int, H: int):
    """Each slab's extended row panel for the ghost-strip multicolor
    sweep: slab d updates rows [d*B - H, d*B + B + H) of the padded square
    operator (temporal blocking: a color step invalidates one coupling
    reach of extended rows a side, so H = steps * reach leaves the block
    exact), columns in extended-x coordinates g - (d*B - H) clamped into
    [0, B + 2H) (an out-of-window reference lies on a row the validity
    induction discards). Returns numpy (dataE, colsE, masksE, diagE) with
    rows (D * (B + 2H), ...): slab d's panel is rows [d*E, (d+1)*E)."""
    rows_pad = D * B
    data_g, cols_g = _ell_arrays(_pad_rows_csr(M, rows_pad, rows_pad))
    K = data_g.shape[1]
    # empty slots reference the row itself (always inside the window)
    cols_g = np.where(data_g == 0, np.arange(rows_pad)[:, None], cols_g)
    E = B + 2 * H
    C = int(colors_pad.max()) + 1
    dataE = np.zeros((D * E, K))
    colsE = np.zeros((D * E, K), dtype=np.int64)
    diagE = np.ones(D * E)
    colorsE = np.full(D * E, -1, dtype=np.int64)  # -1: no color fires
    for d in range(D):
        lo, hi = d * B - H, d * B + B + H
        src_lo, src_hi = max(lo, 0), min(hi, rows_pad)
        dst = d * E + (src_lo - lo)
        m = src_hi - src_lo
        dataE[dst:dst + m] = data_g[src_lo:src_hi]
        colsE[dst:dst + m] = np.clip(cols_g[src_lo:src_hi] - lo, 0, E - 1)
        diagE[dst:dst + m] = diag_pad[src_lo:src_hi]
        colorsE[dst:dst + m] = colors_pad[src_lo:src_hi]
    masksE = np.stack([(colorsE == c) for c in range(C)]).astype(np.float64)
    return dataE, colsE, masksE, diagE


# ---------------------------------------------------------------------------
# Slab ops: vectors are (D, B), slab d's entry i is global entry d*B + i.


def _windows_1d(x, W: int):
    """(..., D, B) -> (..., D, B + 2W): each slab with the W global
    entries before and after it, zeros beyond the ends (a view)."""
    D, B = x.shape[-2:]
    full = launch.frame(x.reshape(*x.shape[:-2], D * B), W, dim=-1)
    return full.unfold(-1, B + 2 * W, B)


def _exchange_w(x, W: int):
    """Window halo (JAX ``_exchange_w``): (left, right), each slab's
    left neighbour's last W entries and right neighbour's first W, zeros
    at the ends."""
    B = x.shape[-1]
    ext = _windows_1d(x, W)
    return ext[:, :W], ext[:, W + B:]


def _exchange_strips_1d(u, b, H: int):
    """One ghost-strip exchange for a whole multicolor sweep: the H-wide
    u and b strips ride one exchange. Returns (u_ext, b_ext), (D, B+2H)."""
    ub = _windows_1d(torch.stack([u, b]), H)
    return ub[0], ub[1]


def _gather(x_ext, cols):
    """x_ext[cols] per slab: (D, E) windows, (D, R, K) window columns."""
    D, R, K = cols.shape
    return torch.gather(x_ext, 1, cols.reshape(D, R * K)).reshape(D, R, K)


def _matvec_local(op: ShardedOp, x):
    """op @ x on the slabs: one W-wide exchange, a gather, a row sum."""
    left, right = _exchange_w(x, op.W)
    x_ext = torch.cat([left, x, right], dim=1)
    return torch.sum(op.data * _gather(x_ext, op.cols), dim=-1)


def _dot(x, y) -> torch.Tensor:
    """sum(x * y) over every slab of every block: each slab's sum (a
    reduction of its own), then the slab sums (``launch.slab_total``), so
    a card group's and the processes' sums are one block's bitwise."""
    return launch.slab_total(torch.stack([(x[d] * y[d]).sum()
                                          for d in range(len(x))]))


def _rss_df(r: DF32) -> torch.Tensor:
    """The f64 rss of a df32 residual over every slab, slab by slab as
    ``_dot``."""
    return launch.slab_total(torch.stack([
        df_rss(DF32(hi=r.hi[d], lo=r.lo[d])) for d in range(len(r.hi))]))


# ---------------------------------------------------------------------------
# The solver


class EllDistSolver(launch.ProgramSolver):
    """Row-partitioned V-cycle solver for a general (banded) hierarchy
    (JAX ``EllDistSolver``).

    Defaults to the reference pipeline: the flat 1-D LinearInterpolator
    transfer and the Galerkin RAP (multigrid.hpp:211-243), multicolor GS
    smoothing. ``halo="step"`` exchanges the W-wide window before every
    color step; ``"strips"`` one H = steps * reach ghost strip per sweep,
    recomputing the neighbours' boundary rows on extended panels (the same
    iterates). ``n_devices`` is the number of slabs and ``device`` where
    they go, DistStructuredSolver's rule (``launch.slab_devices``: None
    spreads them over the visible cards, one device keeps them there, a
    sequence gives a block to each entry). Over several devices the solver
    is a card group: the setup is built once, on the host, ``solve``,
    ``solve_pcg`` and ``solve_ir`` run on every block and return block
    0's result, and ``pad_vec``, ``unpad_vec``, ``rss`` and
    ``vcycle_once`` run on a block inside ``run(fn)``; ``close()`` ends
    its threads. Under a process group each process holds D/P of the
    slabs. ``config`` (a config.MeshConfig) gives n_devices where the
    argument is None, ``min_rows``, a halo mode of this path's, and
    ``cycles_per_refine`` where the argument is None (JAX's rule).
    ``solve`` and ``solve_pcg`` run in ``dtype``; ``solve_ir`` is the df32
    defect correction around f32 V-cycles.

    JAX compiles four programs (``_vcycle``, ``_rss``, ``_refine``,
    ``_pcg``); the port restates each in cond/body form on fixed buffers
    a block (``_state``) and runs it under one of two drivers, ``driver``
    (``launch.ProgramSolver``): ``"graph"`` (the default on the card:
    one block, a card group, a process group or the mesh of both; a CUDA
    graph a program a block, captured at its first use or by ``warmup``;
    ``solve_pcg`` one WHILE graph launch, ``vcycle_once``, ``rss`` and
    each refine of ``solve_ir`` one straight graph launch, ``solve`` and
    ``solve_ir`` reading the rss between them as JAX's host loops do;
    over several blocks the collectives inside are the peer collective
    kernel) or ``"host"`` (the CPU's, and the oracle on the card: the
    same pieces stepped from the host). ``driver`` chooses it (None: the
    default); ``set_driver`` changes it. Under a process group a program
    call is collective, as in ``DistStructuredSolver``.
    """

    def __init__(self, A, b, n_levels: int, n_devices: int | None = None,
                 dtype=torch.float64, interpolator=None, omega: float = 1.0,
                 symmetric: bool = True, min_rows: int = 2,
                 halo: str = "step", config=None,
                 cycles_per_refine: int | None = None, device=None,
                 driver: str | None = None):
        if config is not None:
            if n_devices is None:
                n_devices = config.n_devices
            min_rows = getattr(config, "min_rows_per_device", min_rows)
            cfg_halo = getattr(config, "halo", halo)
            if cfg_halo in HALO_MODES:
                halo = cfg_halo
            if cycles_per_refine is None:
                cycles_per_refine = getattr(config, "cycles_per_refine",
                                            None)
        self.cycles_per_refine = (2 if cycles_per_refine is None
                                  else cycles_per_refine)
        D, self.devices = launch.slab_devices(n_devices, device)
        self.device = self.devices[0]
        self.driver = self._driver_for(driver)
        if halo not in HALO_MODES:
            raise ValueError(f"unknown halo mode {halo!r}; "
                             "expected 'strips' or 'step'")
        self.D = D
        self.dtype = dtype
        self.omega = omega
        self.symmetric = symmetric
        self.halo = halo
        spread = len(self.devices) > 1
        # over several devices the setup is built once, on the host
        dev = torch.device("cpu") if spread else self.device
        A_sp = A.to_scipy() if isinstance(A, ELL) else A.tocsr()
        interp = interpolator or LinearInterpolator(n_levels)

        # the host Galerkin chain (the reference ctor's structure)
        mats, Ps, Rs = [A_sp], [], []
        for _ in range(n_levels - 1):
            n_h = mats[-1].shape[0]
            Pm, Rm = interp.make_operators_scipy(n_h,
                                                 interp.coarse_size(n_h))
            Ps.append(Pm.tocsr())
            Rs.append(Rm.tocsr())
            mats.append((Rm @ (mats[-1] @ Pm)).tocsr())

        # the sharded prefix: B_l = ceil(n_l / D), even; sharded while the
        # windows fit the blocks
        sizes = [M.shape[0] for M in mats]
        Bs = [max(2, -(-s // D)) for s in sizes]
        Bs = [B + (B % 2) for B in Bs]
        ops, Ls = [], 0
        for l in range(n_levels - 1):
            A_op = ShardedOp.build(mats[l], D, Bs[l], Bs[l], dtype,
                                   device=dev)
            R_op = ShardedOp.build(Rs[l], D, Bs[l + 1], Bs[l], dtype,
                                   device=dev)
            P_op = ShardedOp.build(Ps[l], D, Bs[l], Bs[l + 1], dtype,
                                   device=dev)
            if not (A_op.W <= Bs[l] and R_op.W <= Bs[l]
                    and P_op.W <= Bs[l + 1] and Bs[l] >= min_rows
                    and sizes[l] >= D * min_rows):
                break
            ops.append((A_op, R_op, P_op))
            Ls = l + 1
        if Ls == 0:
            raise ValueError(f"problem too small to shard over {D} slabs")
        self.Ls, self.sizes, self.Bs = Ls, sizes, Bs

        # every level's (D, ...) tensors, on dev: each block takes its
        # slabs (_place)
        def tensor(a, *shape, dtype=dtype):
            return torch.tensor(a, dtype=dtype, device=dev).reshape(shape)

        levels, self._ext_meta, ext = [], [], []
        for l in range(Ls):
            masks, diag, colors_pad = self._level_aux(mats[l], l)
            levels.append((*ops[l], tensor(masks, len(masks), D, Bs[l]),
                           tensor(diag, D, Bs[l])))
            # ghost strips: one exchange a sweep. The strip depth comes
            # from the true reach beta = max|col - row| of the level, not
            # from W (W is how far columns overflow the owner's block, but
            # the invalid front of the temporal blocking advances by the
            # whole coupling distance each color step; ADVICE r3). Taken
            # while the strip fits one neighbour slab (H <= B).
            n_steps = 2 * len(masks) if symmetric else len(masks)
            coo = mats[l].tocoo()
            beta = max(int(np.abs(coo.col - coo.row).max()) if coo.nnz
                       else 0, 1)
            H = n_steps * beta
            if halo == "strips" and 0 < H <= Bs[l]:
                dE, cE, mE, gE = build_ext_panels(mats[l], colors_pad, diag,
                                                  D, Bs[l], H)
                E = Bs[l] + 2 * H
                K = dE.shape[1]
                self._ext_meta.append(H)
                ext.append((tensor(dE, D, E, K),
                            tensor(cE, D, E, K, dtype=torch.int64),
                            tensor(mE, len(mE), D, E), tensor(gE, D, E)))
            else:
                self._ext_meta.append(None)
                ext.append(())
        Pb = self._boundary(Ps[Ls - 1], D, dtype, dev)

        # the replicated sub-hierarchy (levels Ls..), single-device
        # machinery, on every block
        self.sub_smoother = MulticolorGaussSeidel(omega=omega,
                                                  symmetric=symmetric)
        sub_hier = build_hierarchy(
            mats[Ls], n_levels - Ls, _FixedChain(Ps[Ls:], Rs[Ls:],
                                                 sizes[Ls:]),
            self.sub_smoother, dtype=dtype, device=dev)

        # the df32 split of the fine operator, from its f64 values
        a64 = ShardedOp.build(mats[0], D, Bs[0], Bs[0], as_numpy=True).data
        a_hi = a64.astype(np.float32)
        a_lo = (a64 - a_hi.astype(np.float64)).astype(np.float32)
        A0_df = DF32(hi=torch.tensor(a_hi, device=dev),
                     lo=torch.tensor(a_lo, device=dev))
        b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else b
        self._b64 = np.asarray(b, dtype=np.float64)
        full = (levels, ext, Pb, A0_df)
        if not spread:
            self._place(self.device, full, sub_hier)
            return
        self.b = torch.tensor(self._b64, dtype=dtype, device=self.device)
        self._spread(lambda block, dev: block._place(
            dev, full, copy.deepcopy(sub_hier).to(dev)))

    def _place(self, device, full, sub_hier) -> "EllDistSolver":
        """Put this block's slabs of the setup (``full``: the levels' ops,
        masks and diagonals, the ghost-strip panels, the boundary
        prolongation, the fine operator's df32 split, each with all D
        slabs) and the sub-hierarchy on ``device``."""
        levels, ext, Pb, A0_df = full
        self.device = device
        self.mesh = mesh = launch.device_mesh_1d(self.D)

        def on(t, dim=0):
            return mesh.local(t, dim).to(device)

        self.levels = [dict(A=A_op.local(mesh, device),
                            R=R_op.local(mesh, device),
                            P=P_op.local(mesh, device),
                            masks=on(masks, dim=1), diag=on(diag))
                       for A_op, R_op, P_op, masks, diag in levels]
        self._ext = []
        for e in ext:
            if e:
                dE, cE, mE, gE = e
                e = (on(dE), on(cE), on(mE, dim=1), on(gE))
            self._ext.append(e)
        self._Pb_data, self._Pb_cols = on(Pb[0]), on(Pb[1])
        self._A0_df = DF32(hi=on(A0_df.hi), lo=on(A0_df.lo))
        self.sub_hier = sub_hier
        self.b = torch.tensor(self._b64, dtype=self.dtype, device=device)
        if device.type == "cuda" and launch.process_count() > 1:
            self._make_handles()
        self._loop = None               # the programs' buffers and pieces
        self._graphs = {}               # their graphs, by program
        self._coll = None               # the peer collectives' memory
        return self

    def _make_handles(self) -> None:
        """Create this block's cuSOLVER handle (the sub-hierarchy's
        coarsest solve) now, while no block waits: creating one
        synchronizes the whole card (in a card thread) or this process's
        work on it, which mid-solve could wait for another block's
        collective that waits for this block."""
        n = self.sub_hier.levels[-1].A.n_rows
        self.sub_hier.coarse.solve(torch.zeros(n, dtype=self.dtype,
                                               device=self.device))
        torch.cuda.current_stream().synchronize()

    def close(self) -> None:
        """Drop the graphs and release the peer collectives' memory:
        collective under a process group (every process calls it, before
        the group is destroyed); on a card group on every block, then the
        threads end (after a failure the memory is left to the process's
        end). The solver is not used after."""
        if self._blocks is not None:
            self._close_group(EllDistSolver.close)
            return
        self._close_programs()

    def _level_aux(self, M, l: int):
        """The level's greedy colors as (C, D*B) masks, its diagonal and
        its padded colors; a padding row takes color 0 (diagonal 1, b 0:
        it stays 0)."""
        n, rows_pad = self.sizes[l], self.D * self.Bs[l]
        ell = ELL.from_scipy(M, dtype=self.dtype, device="cpu")
        colors = greedy_coloring(ell.cols.numpy(), ell.data.numpy(), n)
        colors_pad = np.zeros(rows_pad, dtype=np.int64)
        colors_pad[:n] = colors
        masks = np.stack([(colors_pad == c)
                          for c in range(int(colors.max()) + 1)]
                         ).astype(np.float64)
        diag = np.ones(rows_pad)
        diag[:n] = M.diagonal()
        return masks, diag, colors_pad

    def _boundary(self, Pb, D: int, dtype, dev):
        """The prolongation from the replicated level Ls onto the sharded
        level Ls-1: ELL panels with global coarse columns, (D, rows, K)
        data and columns."""
        n_f = self.sizes[self.Ls - 1]
        rows_pad = D * self.Bs[self.Ls - 1]
        Pp = sp.vstack([Pb, sp.csr_matrix((rows_pad - n_f, Pb.shape[1]))]
                       ).tocsr()
        Pp.sort_indices()
        data, cols = _ell_arrays(Pp)
        K = data.shape[1]
        return (torch.tensor(data, dtype=dtype, device=dev).reshape(D, -1, K),
                torch.tensor(cols, device=dev).reshape(D, -1, K))

    # -- the V-cycle --------------------------------------------------------

    def _mc_sweep(self, l: int, u, b):
        lv = self.levels[l]
        C = lv["masks"].shape[0]
        order = list(range(C))
        if self.symmetric:
            order = order + order[::-1]
        if self._ext[l]:
            # one H-wide exchange, then every color step on the extended
            # rows (temporal blocking)
            dataE, colsE, masksE, diagE = self._ext[l]
            H = self._ext_meta[l]
            u_ext, b_ext = _exchange_strips_1d(u, b, H)
            for c in order:
                r = b_ext - torch.sum(dataE * _gather(u_ext, colsE), dim=-1)
                u_ext = u_ext + (self.omega * masksE[c]) * (r / diagE)
            return u_ext[:, H:H + lv["A"].B_x]
        for c in order:
            r = b - _matvec_local(lv["A"], u)
            u = u + (self.omega * lv["masks"][c]) * (r / lv["diag"])
        return u

    def _vcycle_raw(self, u_pad, b_pad):
        """One V-cycle on this block's (D/P, B_0) slabs (the pieces'
        form of JAX's ``vcycle_local``)."""
        Ls = self.Ls
        us, bs = [u_pad] + [None] * (Ls - 1), [b_pad] + [None] * (Ls - 1)
        b_repl = None
        for l in range(Ls):
            lv = self.levels[l]
            us[l] = self._mc_sweep(l, us[l], bs[l])
            r = bs[l] - _matvec_local(lv["A"], us[l])
            coarse = _matvec_local(lv["R"], r)
            if l < Ls - 1:
                bs[l + 1], us[l + 1] = coarse, torch.zeros_like(coarse)
            else:                                        # all_gather
                b_repl = launch.all_gather_slabs(coarse).reshape(-1)[
                    :self.sizes[Ls]]
        u_repl = vcycle(self.sub_hier, self.sub_smoother,
                        torch.zeros_like(b_repl), b_repl)
        for l in range(Ls - 1, -1, -1):
            lv = self.levels[l]
            if l == Ls - 1:
                u_pad1 = torch.cat([u_repl, u_repl.new_zeros(1)])
                corr = torch.sum(self._Pb_data * u_pad1[self._Pb_cols],
                                 dim=-1)
            else:
                corr = _matvec_local(lv["P"], us[l + 1])
            us[l] = self._mc_sweep(l, us[l] + corr, bs[l])
        return us[0]

    # -- the programs (launch.ProgramSolver runs them) ------------------------

    def _state(self) -> SimpleNamespace:
        """This block's programs in JAX's cond/body form on fixed buffers
        (built once): ``straight`` the pieces with no loop (``vcycle``:
        ``u`` <- V-cycle(``u``, ``b``); ``rss``; for an f32 hierarchy
        ``refine``: one df32 refine from (``uh``, ``ul``) on (``bh``,
        ``bl``) into (``uh2``, ``ul2``), ``r_err`` the rss of the iterate
        it started from, the cycles always run), ``loops`` the
        ``graph_loop.DeviceLoop`` and (pre, post) of ``pcg`` (JAX's
        pcg_local: err = dot(r0, r0) at the start, every pass refines,
        the tolerance in ``dtype``)."""
        if self._loop is not None:
            return self._loop
        dev, dt = self.device, self.dtype
        f32, f64, i32 = torch.float32, torch.float64, torch.int32
        shape = (self.D // launch.process_count(), self.Bs[0])

        def z(shape_=shape, dtype=dt):
            return torch.zeros(shape_, dtype=dtype, device=dev)
        L = SimpleNamespace(
            u=z(), b=z(), rss=z(()), r=z(), z=z(), p=z(), rz=z(()),
            p_err=z(()), p_tol=z(()), p_err64=z((), f64),
            p_tol64=z((), f64), p_it=z((), i32), p_n=z((), i32),
            p_stats=z((2,)))
        A0 = self.levels[0]["A"]

        def vcycle():
            L.u.copy_(self._vcycle_raw(L.u, L.b))

        def rss():
            r = L.b - _matvec_local(A0, L.u)
            L.rss.copy_(_dot(r, r))

        def precond(r):
            return -self._vcycle_raw(torch.zeros_like(r), r)

        def A_neg(x):
            return -_matvec_local(A0, x)

        def set_err(r):
            L.p_err.copy_(_dot(r, r))
            L.p_err64.copy_(L.p_err)

        def pcg_pre():
            r = -L.b
            z_ = precond(r)
            L.u.zero_()
            L.r.copy_(r)
            L.z.copy_(z_)
            L.p.copy_(z_)
            L.rz.copy_(_dot(r, z_))
            set_err(r)
            L.p_tol64.copy_(L.p_tol)
            L.p_it.zero_()

        def pcg_body():
            for buf, x in zip((L.u, L.r, L.z, L.p, L.rz),
                              _step(A_neg, precond, L.u, L.r, L.z, L.p,
                                    L.rz, dot=_dot)):
                buf.copy_(x)
            set_err(L.r)

        def pcg_post():
            L.p_stats.copy_(torch.stack([L.p_err, L.p_it.to(dt)]))

        L.straight = {"vcycle": vcycle, "rss": rss}
        L.loops = {"pcg": (graph_loop.DeviceLoop(
            pcg_body, err=L.p_err64, tol=L.p_tol64, it=L.p_it, n=L.p_n),
            pcg_pre, pcg_post)}
        if dt == f32:
            for name in ("bh", "bl", "uh", "ul", "uh2", "ul2"):
                setattr(L, name, z(shape, f32))
            L.r_err = z((), f64)
            b_df, u = DF32(hi=L.bh, lo=L.bl), DF32(hi=L.uh, lo=L.ul)

            def refine():
                r = self._df_residual(u, b_df)
                L.r_err.copy_(_rss_df(r))
                e = torch.zeros_like(r.hi)
                for _ in range(self.cycles_per_refine):
                    e = self._vcycle_raw(e, r.hi)
                un = df_add_f32(u, e)
                L.uh2.copy_(un.hi)
                L.ul2.copy_(un.lo)
            L.straight["refine"] = refine
        self._loop = L
        return L

    # -- public API ---------------------------------------------------------

    @launch.block_local
    def pad_vec(self, v) -> torch.Tensor:
        """The (n,) vector as this block's (D/P, B_0) slabs in
        ``dtype``, zero padding."""
        out = torch.zeros(self.D * self.Bs[0], dtype=self.dtype,
                          device=self.device)
        out[:self.sizes[0]] = torch.as_tensor(v).to(out)
        return self.mesh.local(out.reshape(self.D, self.Bs[0]))

    @launch.block_local
    def unpad_vec(self, v) -> torch.Tensor:
        """Slabs -> the (n,) vector, gathered from every block."""
        return launch.all_gather_slabs(v).reshape(-1)[:self.sizes[0]]

    @launch.block_local
    def vcycle_once(self, u_pad, b_pad):
        """One V-cycle on this block's (D/P, B_0) slabs (JAX's
        ``_vcycle``): one graph launch under the graph driver."""
        L = self._state()

        def inputs():
            L.u.copy_(u_pad)
            L.b.copy_(b_pad)
        self._run("vcycle", inputs)
        return L.u.clone()

    def _read_rss(self) -> float:
        error = check_rss(float(self._state().rss))
        self._check()
        return error

    @launch.block_local
    def rss(self, u_pad, b_pad) -> float:
        """The rss of the slabs summed over every block (JAX's ``_rss``):
        one graph launch under the graph driver, then its read."""
        L = self._state()

        def inputs():
            L.u.copy_(u_pad)
            L.b.copy_(b_pad)
        self._run("rss", inputs)
        return self._read_rss()

    @launch.every_block
    def solve(self, tolerance=1e-9, compute_error_every_n_iters=5,
              n_iters=100) -> SolveResult:
        """The reference's outer loop (multigrid.hpp:311-337): V-cycles in
        ``dtype`` (one ``vcycle`` program each), the rss every
        ``compute_error_every_n_iters`` (the ``rss`` program and its
        read), as JAX's host loop."""
        b_pad = self.pad_vec(self.b)
        L = self._state()
        self._build("vcycle")
        self._build("rss")
        L.b.copy_(b_pad)
        L.u.zero_()
        every = compute_error_every_n_iters
        it, error = 0, 100.0
        history = []
        while it < n_iters and error > tolerance:
            k = (min(every - (it % every), n_iters - it) if every
                 else n_iters - it)
            for _ in range(k):
                self._go("vcycle")
            it += k
            if every and it % every == 0:
                self._go("rss")
                error = self._read_rss()
                history.append((it, error))
        return SolveResult(u=self.unpad_vec(L.u.clone()), iterations=it,
                           error=error, converged=error <= tolerance,
                           history=history)

    @launch.every_block
    def solve_pcg(self, tolerance: float = 1e-9, n_iters: int = 100
                  ) -> SolveResult:
        """AMG-preconditioned CG on the negated (SPD) system in ``dtype``
        (JAX ``pcg_local``): M^-1 minus one V-cycle from zero, the inner
        products summed over the slabs, the recurrence rss checked against
        ``tolerance`` (in ``dtype``) once per iteration, on the device
        under the graph driver (one graph launch, one read of its stats),
        once a pass on the host under the host one. One history entry, as
        JAX."""
        b = self.pad_vec(self.b)
        L = self._state()

        def inputs():
            L.b.copy_(b)
            L.p_tol.fill_(tolerance)
            L.p_n.fill_(n_iters)
        self._run("pcg", inputs)
        error, it = L.p_stats.tolist()
        self._check()
        check_rss(error)
        it = int(it)
        return SolveResult(u=self.unpad_vec(L.u.clone()), iterations=it,
                           error=error, converged=error <= tolerance,
                           history=[(it, error)])

    def _df_residual(self, u: DF32, b: DF32) -> DF32:
        """r = b - A u on the fine slabs in double-float32: the hi and lo
        windows ride one exchange, the K products are df32 TwoProds summed
        slot by slot left to right (JAX's order)."""
        A0 = self.levels[0]["A"]
        ext = _windows_1d(torch.stack([u.hi, u.lo]), A0.W)
        prod = df_mul(self._A0_df, DF32(hi=_gather(ext[0], A0.cols),
                                        lo=_gather(ext[1], A0.cols)))
        acc = DF32(hi=prod.hi[..., 0], lo=prod.lo[..., 0])
        for k in range(1, prod.hi.shape[-1]):
            acc = df_add(acc, DF32(hi=prod.hi[..., k], lo=prod.lo[..., k]))
        return df_add(b, df_neg(acc))

    @launch.every_block
    def solve_ir(self, tolerance=1e-9, n_refine: int = 40) -> SolveResult:
        """The df32 defect correction for an f32 hierarchy (JAX's
        ``_refine`` program a step, one graph launch under the graph
        driver): each step returns the corrected iterate and the df32 rss
        of the one it started from (the one host read), and the
        correction, ``cycles_per_refine`` f32 V-cycles on the residual,
        is kept only while that rss is above ``tolerance``. Reaches the
        reference's 1e-9-grade rss (testlib.cpp:158) with f32 V-cycles;
        an f64 hierarchy uses solve()."""
        if self.dtype != torch.float32:
            raise NotImplementedError(
                "solve_ir is the f32+df32 path; an f64 hierarchy reaches "
                "reference tolerances with solve() directly")
        bh = self._b64.astype(np.float32)
        bl = (self._b64 - bh.astype(np.float64)).astype(np.float32)
        bh, bl = (self.pad_vec(torch.from_numpy(x)) for x in (bh, bl))
        L = self._state()
        self._build("refine")
        L.bh.copy_(bh)
        L.bl.copy_(bl)
        L.uh.zero_()
        L.ul.zero_()
        history, it, error = [], 0, float("inf")
        for _ in range(n_refine):
            self._go("refine")
            error = check_rss(float(L.r_err))
            self._check()
            history.append((it, error))
            if error <= tolerance:
                break
            L.uh.copy_(L.uh2)
            L.ul.copy_(L.ul2)
            it += self.cycles_per_refine
        u64 = (self.unpad_vec(L.uh.clone()).to(torch.float64)
               + self.unpad_vec(L.ul.clone()).to(torch.float64))
        return SolveResult(u=u64, iterations=it, error=error,
                           converged=error <= tolerance, history=history)


class _FixedChain:
    """Interpolator facade replaying a computed P/R chain (builds the
    replicated sub-hierarchy without recomputing the operators)."""

    def __init__(self, Ps, Rs, sizes):
        self._Ps = list(Ps)
        self._Rs = list(Rs)
        self._sizes = list(sizes)
        self._i = 0
        self.level_to_P = {}
        self.level_to_R = {}

    def coarse_size(self, n_h):
        return self._Ps[self._i].shape[1]

    def make_operators_scipy(self, n_h, n_H):
        Pm, Rm = self._Ps[self._i], self._Rs[self._i]
        self._i += 1
        return Pm, Rm

    def set_level_to_P(self, level, P):
        self.level_to_P[level] = P

    def set_level_to_R(self, level, R):
        self.level_to_R[level] = R
