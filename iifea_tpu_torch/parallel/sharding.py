"""SPMD execution over ``torch.distributed`` ranks (port of
``iifea_tpu/parallel/sharding.py``).

The JAX package runs one program over a 1-D 'dp' device mesh with
``shard_map`` and lets sharded arrays carry global semantics. Here each
rank is a process holding local tensors, and every exchange is an explicit
collective of its ``DeviceMesh``:

* ``all_reduce``: a sum over the ranks, formed as an all-gather followed
  by a sum in rank order, so every rank holds the same bits whatever the
  backend's reduction order (a rank-dependent last bit would send the
  ranks down different Krylov branches);
* ``halo``: the neighbour exchange of a row block's first and last rows
  (zeros at the two ends: the lattice's zero halo);
* ``gather_rows``: the all-gather of row blocks of uneven length.

The backend is the caller's choice: ``'nccl'`` puts one rank on each card
(more ranks than cards raises), ``'gloo'`` runs on the CPU or puts several
ranks on one card. Gloo has no CUDA send, receive or all-gather, so with
CUDA tensors every collective stages through pinned host buffers; the mesh
names that route (``DeviceMesh.route``) and callers print it.

``launch`` spawns the ranks (``torch.multiprocessing``, start method
``spawn``, a ``file://`` rendezvous in a temporary directory) and returns
their results; a rank that fails fails the launch.

``ShardedProjectedSystem`` is the background system with the cells
sharded: each rank takes a contiguous share of every term's cells, gathers
its local values from the replicated background vector through the
extraction rows (M fused into the element gather), runs the form's kernels
on its cells, sums onto background dofs in a fixed order
(``ops/segment.SegmentSum``) and ends every apply in one ``all_reduce``.
"""
from __future__ import annotations

import datetime
import gc
import os
import pickle
import queue
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from iifea_tpu_torch.ops.assembly import JAC_CHUNK, _ctx_dims
from iifea_tpu_torch.ops.segment import SegmentSum

BACKENDS = ("nccl", "gloo")


def even_bounds(n: int, size: int) -> list[int]:
    """Boundaries of ``size`` contiguous shares of n items, balanced to one
    item: share k is [b[k], b[k+1])."""
    return [k * n // size for k in range(size + 1)]


def nested_bounds(rows: list[int], size: int) -> list[list[int]]:
    """Row boundaries of the levels of a hierarchy, rows[l+1] =
    (rows[l] − 1)/2 + 1: balanced on the coarsest level, and each finer
    level's boundary twice the coarser's, so a coarse row block's fine rows
    lie in the fine block of the same rank plus one neighbour row
    (restriction and prolongation need a one-row halo)."""
    b = even_bounds(rows[-1], size)
    out = [b]
    for n in reversed(rows[:-1]):
        b = [2 * v for v in b[:-1]] + [n]
        out.append(b)
    return out[::-1]


class DeviceMesh:
    """A 1-D mesh of ranks: this rank, the world size, its device, the
    process group and backend, and the collectives of the sharded
    operators. ``collectives`` counts the collective calls made (a halo
    exchange is one). With size 1 and no process group every collective
    is local."""

    def __init__(self, rank: int, size: int, device, backend: str = "gloo",
                 group=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.backend = backend
        self.group = group
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError("the nccl backend takes CUDA devices")
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.route = (f"{backend}, staged through pinned host buffers"
                      if self.staged else backend)
        self.collectives = 0

    # -- wire buffers ---------------------------------------------------------

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of t to hand to the backend: pinned host memory
        for gloo with CUDA tensors."""
        if not self.staged:
            return t.contiguous()
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf

    def _empty(self, shape, dtype) -> torch.Tensor:
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _home(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staged else t

    # -- collectives ----------------------------------------------------------

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's t (equal shapes), in rank order."""
        self.collectives += 1
        if self.size == 1:
            return [t]
        src = self._wire(t)
        parts = [self._empty(t.shape, t.dtype) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return [self._home(p) for p in parts]

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks of t, added in rank order on every rank: the
        same bits everywhere and on every run."""
        if self.size == 1:
            self.collectives += 1
            return t
        parts = self.all_gather(t)
        s = parts[0]
        for p in parts[1:]:
            s = s + p
        return s

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The inner product of two row-block vectors: the local dot
        summed over the ranks (``krylov.cg``'s ``dot`` hook)."""
        return self.all_reduce(torch.dot(a, b))

    def halo(self, x: torch.Tensor, width: int) -> torch.Tensor:
        """x (nF, rows, ...) extended by ``width`` rows on each side: the
        previous rank's last rows above, the next rank's first rows below,
        zeros beyond the first and the last rank."""
        self.collectives += 1
        shape = (x.shape[0], width, *x.shape[2:])
        top = bot = None
        ops = []
        if self.rank > 0:
            top = self._empty(shape, x.dtype)
            ops += [dist.P2POp(dist.isend, self._wire(x[:, :width]),
                               self.rank - 1, self.group),
                    dist.P2POp(dist.irecv, top, self.rank - 1, self.group)]
        if self.rank < self.size - 1:
            bot = self._empty(shape, x.dtype)
            ops += [dist.P2POp(dist.isend, self._wire(x[:, -width:]),
                               self.rank + 1, self.group),
                    dist.P2POp(dist.irecv, bot, self.rank + 1, self.group)]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        zeros = x.new_zeros(shape)
        return torch.cat([zeros if top is None else self._home(top), x,
                          zeros if bot is None else self._home(bot)], dim=1)

    def gather_rows(self, x: torch.Tensor, bounds: list[int]) -> torch.Tensor:
        """The row blocks x (nF, rows_k, ...) of all ranks, rank k's holding
        rows [bounds[k], bounds[k+1]), joined into (nF, bounds[-1], ...)."""
        counts = [b1 - b0 for b0, b1 in zip(bounds[:-1], bounds[1:])]
        if self.size == 1:
            self.collectives += 1
            return x
        wide = max(counts)
        pad = x.new_zeros((x.shape[0], wide - x.shape[1], *x.shape[2:]))
        parts = self.all_gather(torch.cat([x, pad], dim=1))
        return torch.cat([p[:, :c] for p, c in zip(parts, counts)], dim=1)

    def barrier(self) -> None:
        if self.size > 1:
            self.all_gather(torch.zeros(1, device=self.device))


# -- launching ranks -------------------------------------------------------------


def _to_cpu(obj):
    """A rank's result with every tensor on the host (it is pickled by
    value back to the launching process)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):    # NamedTuple
        return type(obj)(*(_to_cpu(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _rank_main(fn, rank, size, backend, device, init, timeout, inbox, out):
    """Body of one spawned rank: take fn's arguments from ``inbox``, join
    the group, run fn(mesh, *args), send back (rank, error text or None,
    pickled result). The arguments come by queue, not with the process:
    a process's own arguments are written while it starts, so large ones
    would start the ranks one after another; and they are released before
    the process ends (CUDA IPC counts their users)."""
    try:
        args = inbox.get()
        dev = torch.device(device)
        if dev.type == "cuda":
            index = rank if backend == "nccl" else (dev.index or 0)
            dev = torch.device("cuda", index)
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=timeout), **kw)
        try:
            mesh = DeviceMesh(rank, size, dev, backend, dist.group.WORLD)
            mesh.barrier()
            result = fn(mesh, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            del args
            gc.collect()
            dist.destroy_process_group()
        out.put((rank, None, pickle.dumps(_to_cpu(result))))
    except BaseException:
        out.put((rank, traceback.format_exc(), None))
        sys.exit(1)


def _collect(out, procs, timeout: float):
    """(results in rank order, {rank: error text}) from the ranks' queue:
    stops at the first error, at a rank that died without reporting (after
    a grace period for its message), or at the deadline (rank −1). The
    queue is drained before any process is joined."""
    size = len(procs)
    results, errors, done, dead_since = [None] * size, {}, set(), {}
    deadline = time.monotonic() + timeout
    while len(done) < size and not errors:
        try:
            rank, err, payload = out.get(timeout=0.5)
        except queue.Empty:
            now = time.monotonic()
            for rank, p in enumerate(procs):
                if rank in done or p.exitcode in (None, 0):
                    continue
                if now - dead_since.setdefault(rank, now) > 2.0:
                    errors[rank] = (f"exited with code {p.exitcode} "
                                    "without a result")
            if not errors and now > deadline:
                errors[-1] = f"no result within {timeout} s"
            continue
        if err is not None:
            errors[rank] = err
        else:
            results[rank] = pickle.loads(payload)
            done.add(rank)
    return results, errors


def check_backend(backend: str, size: int, device) -> None:
    """Refuse a backend that cannot place ``size`` ranks on ``device``:
    nccl needs CUDA and one card per rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise ValueError("the nccl backend takes CUDA devices; use "
                         "backend='gloo' on the CPU")
    cards = torch.cuda.device_count()
    if size > cards:
        raise ValueError(
            f"nccl puts one rank on each card: {size} ranks, {cards} "
            "card(s); use backend='gloo' to put several ranks on one card")


def launch(fn, size: int, backend: str, args=(), device="cuda",
           timeout: float = 900.0) -> list:
    """Run ``fn(mesh, *args)`` on ``size`` new processes, one rank each,
    and return their results in rank order (tensors come back on the
    host). ``fn`` must be importable by name (a module-level function);
    ``args`` are sent as torch.multiprocessing sends them (CUDA tensors
    by IPC handle, so the ranks share the caller's device memory).

    Ranks with backend 'nccl' take cards cuda:0 … cuda:size−1; with 'gloo'
    they all take ``device``. A rank that raises, or dies, or a launch
    that outlasts ``timeout`` seconds stops every rank and raises."""
    check_backend(backend, size, device)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="iifea_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        inbox, out = ctx.Queue(), ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, rank, size, backend, str(device),
                                   init, timeout, inbox, out))
                 for rank in range(size)]
        for p in procs:
            p.start()
        for _ in procs:
            inbox.put(args)
        # a rank that dies unread must not hold this process at its exit
        inbox.cancel_join_thread()
        try:
            results, errors = _collect(out, procs, timeout)
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
                    p.join()
            if torch.cuda.is_initialized():
                torch.cuda.ipc_collect()    # the ranks' IPC handles are gone
    if errors:
        rank = min(errors)
        who = "the launch" if rank < 0 else f"rank {rank} of {size}"
        raise RuntimeError(f"{who} failed ({backend}):\n{errors[rank]}")
    return results


# -- the sharded background system ------------------------------------------------


class _FusedTerm:
    """One integral term's share of cells on this rank, with the
    extraction fused into its element gather: background dof ids and
    weights (km, ne, nE_local) of each local dof, and the fixed-order sum
    of the element vectors onto the background dofs."""

    def __init__(self, dom, kern, sl, M, n):
        self.dom, self.kern, self.sl = dom, kern, sl
        self.Fidx, self.Fval = M.row_blocks(dom.eldofsT[:, sl])
        self.n_elem = self.Fidx.shape[-1]
        self.scatter = SegmentSum(self.Fidx, n, keep=self.Fval != 0)

    def chunks(self):
        """(local slice, domain slice) of element chunks of JAC_CHUNK."""
        for s in range(0, self.n_elem, JAC_CHUNK):
            e = min(s + JAC_CHUNK, self.n_elem)
            yield slice(s, e), slice(self.sl.start + s, self.sl.start + e)


class ShardedProjectedSystem:
    """The background system Mᵀ A_f M under SPMD: cells sharded over the
    mesh's ranks, the background vector replicated, extraction fused into
    the element gather, one ``all_reduce`` per apply.

    Each rank's share of a term's cells is contiguous and balanced to one
    cell (no padding cells: local tensors need not match in length). The
    element kernels are the form's (``Form._local``: vmap, jacfwd)."""

    def __init__(self, form, M, mesh: DeviceMesh):
        self.form, self.M, self.mesh = form, M, mesh
        self.n = M.n_bg_dofs
        self.n_fields = form.n_fields
        self.terms = []
        for dom, kern in form.terms:
            b = even_bounds(dom.n_elem, mesh.size)
            sl = slice(b[mesh.rank], b[mesh.rank + 1])
            self.terms.append(_FusedTerm(dom, kern, sl, M, self.n))

    def _gather_local(self, t: _FusedTerm, x, sl=slice(None)):
        """Local values (nb, nF, nE) of the background vector x on the
        term's cells ``sl``: u_loc = Σ_k Fval[k]·x[Fidx[k]]."""
        vals = (t.Fval[..., sl] * x[t.Fidx[..., sl]]).sum(0)      # (ne, nE)
        ne = vals.shape[0]
        return vals.reshape(ne // self.n_fields, self.n_fields, -1)

    def _local(self, t: _FusedTerm, params, with_jac: bool, u, lsl, dsl):
        """The form's vmapped element kernel on the chunk's cells:
        (Jacobians, residuals) (ne, ne, nE), (ne, nE)."""
        ctx = t.dom.ctx(dsl)
        nb = t.Fidx.shape[1] // self.n_fields
        vloc = self.form._local(t.kern, nb, params, with_jac, _ctx_dims(ctx))
        return vloc(self._gather_local(t, u, lsl), {}, ctx)

    def residual_b(self, u_p: torch.Tensor, params=None) -> torch.Tensor:
        """r_b = Mᵀ R(M u_p): this rank's cells, summed over the ranks."""
        out = torch.zeros(self.n, dtype=u_p.dtype, device=u_p.device)
        for t in self.terms:
            rloc = torch.zeros(t.Fidx.shape[1:], dtype=u_p.dtype,
                               device=u_p.device)
            for lsl, dsl in t.chunks():
                rloc[:, lsl] = self._local(t, params, False, u_p, lsl, dsl)[1]
            t.scatter((rloc[None] * t.Fval).reshape(-1), out=out)
        return self.mesh.all_reduce(out)

    def assemble_blocks(self, u_p: torch.Tensor, params=None) -> list:
        """This rank's element Jacobians K (ne, ne, nE_local) per term, at
        the background state u_p (they stay on their rank)."""
        blocks = []
        for t in self.terms:
            ne = t.Fidx.shape[1]
            K = torch.zeros((ne, ne, t.n_elem), dtype=u_p.dtype,
                            device=u_p.device)
            for lsl, dsl in t.chunks():
                K[..., lsl] = self._local(t, params, True, u_p, lsl, dsl)[0]
            blocks.append(K)
        return blocks

    def matvec(self, blocks, x: torch.Tensor) -> torch.Tensor:
        """y = Mᵀ A_f M x from this rank's blocks, summed over the
        ranks."""
        y = torch.zeros(self.n, dtype=x.dtype, device=x.device)
        for t, K in zip(self.terms, blocks):
            xe = (t.Fval * x[t.Fidx]).sum(0)                       # (ne, nE)
            ye = (K * xe[None]).sum(dim=1)                         # (ne, nE)
            t.scatter((ye[None] * t.Fval).reshape(-1), out=y)
        return self.mesh.all_reduce(y)

    def diag(self, blocks, chunk: int = 65536) -> torch.Tensor:
        """diag(Mᵀ A_f M) from this rank's blocks, summed over the ranks
        (``BackgroundOperator.diag``'s element-block reduction)."""
        d = torch.zeros(self.n, dtype=blocks[0].dtype,
                        device=blocks[0].device)
        for t, K in zip(self.terms, blocks):
            for s in range(0, t.n_elem, chunk):
                ic = t.Fidx[..., s:s + chunk]
                vc = t.Fval[..., s:s + chunk].to(K.dtype)
                eq = (ic[:, :, None, None, :]
                      == ic[None, None, :, :, :]).to(K.dtype)
                T = torch.einsum("abE,KaLbE,LbE->KaE",
                                 K[..., s:s + chunk], eq, vc) * vc
                SegmentSum(ic, self.n, keep=vc != 0)(T.reshape(-1), out=d)
        return self.mesh.all_reduce(d)

    def make_step(self, rtol: float = 1e-8, atol: float = 1e-12,
                  max_it: int = 500):
        """The full step: assemble → project → Jacobi-CG → update. The CG
        runs on replicated vectors, so its dots need no collective; every
        apply ends in one all_reduce."""
        from iifea_tpu_torch.solvers import krylov
        from iifea_tpu_torch.solvers.precond import jacobi

        def step(u_p, params=None):
            blocks = self.assemble_blocks(u_p, params)
            b = -self.residual_b(u_p, params)
            d = self.diag(blocks)
            du, info = krylov.cg(lambda v: self.matvec(blocks, v), b,
                                 minv=jacobi(d), rtol=rtol, atol=atol,
                                 max_it=max_it)
            return u_p + du, info

        return step
