"""Serving API: a loaded checkpoint that turns conditions into solutions.

Counterpart of ``diffsg_tpu/serve.py``: ``suggest_buckets``, and
``Solver`` with batch buckets and a validity mask, the CFG-DDPM and DDIM
samplers, best-of-N with omega mixtures, projected-gradient refinement
after the decode (``refine_iters``), ``warmup``, ``solve_chunked`` and the
device mesh (``mesh``, ``parallel.mesh``: every rank of a ``(dp, tp)`` mesh
serves its dp shard of each request and returns the whole answer).

Where JAX compiles one program per bucket, the port captures one CUDA graph
per bucket and configuration (``warmup``, or the first ``solve`` of a
configuration) and replays it. Sizes above the largest bucket, Solvers
without buckets, and the CPU run eagerly; a capture that fails raises.

Example:
    from diffsg_tpu_torch.serve import Solver
    solver = Solver.from_checkpoint("ckpts/ddpm_msr_3c_T100", task="msr",
                                    buckets=(1024, 8192))
    solver.warmup(configs=[{}, {"best_of": 4, "omega": [150, 500, 2000, 5000]}])
    P = solver.solve(X)                  # (B, 3) powers, each row sums to W
    P = solver.solve(X, omega=[150, 500, 2000, 5000], best_of=4)

    nu = Solver.from_checkpoint("ckpts/ddpm_nu_3u_aug32_s8c", task="nu_direct",
                                backend="mega")
    S = nu.solve(X_users, omega=0.125, sampler="ddim", n_steps=3)   # (B, 5)

    # CO: ckpts/ddpm_co records no dataset config; these are the values of
    # its training set (datasets/3nodes_50000samples_new.csv).
    co = Solver.from_checkpoint("ckpts/ddpm_co", task="co", dataset_config={
        "node_num": 3, "scaler_min": 0.001618138251306864,
        "scaler_max": 9.996995111158247})
    Y = co.solve(X_features)             # (B, 3) shares, omega 500

    # Hybrid: 50 projected-gradient steps on the exact rate after the decode.
    hybrid = Solver.from_checkpoint("ckpts/ddpm_msr_3c_T100", task="msr", refine_iters=50)

    # One multi-task net, three faces (T=20, x0): each face pads its own
    # condition into the shared one and decodes its own columns.
    co_face = Solver.from_checkpoint("ckpts/ddpm_multi", task="multi_co")
    Y = co_face.solve(X_features, omega=0.5)          # (B, 3), as co_ranked

    # A mesh: one process per card, every rank calls solve with the same X.
    from diffsg_tpu_torch.parallel import init_process, make_mesh
    init_process(rank, world, "file:///path/to/store")
    mesh = make_mesh(world)
    meshed = Solver.from_checkpoint("ckpts/ddpm_msr_3c_T100", task="msr", mesh=mesh,
                                    buckets=(8192,))
    P = meshed.solve(X)                  # (B, 3) on every rank
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .diffusion.ddim import ddim_sample, respaced_steps
from .diffusion.ddpm import cfg_sample
from .diffusion.schedule import Schedule
from .models.unet1d_fused import unet_apply_fn
from .ops import mega, resblock
from .parallel.mesh import Mesh, all_gather_rows, shard_params
from .tasks import TASKS
from .tasks.base import Task, loaded_model, refine_solutions, select_best
from .tasks.multi import merge_multi_config
from .utils.checkpoint import load_checkpoint


def suggest_buckets(sizes: Sequence[int], max_buckets: int = 4, align: int = 64,
                    dp: int = 1) -> List[int]:
    """Pick batch-size buckets from an observed request-size histogram.

    Upper quantiles of the observed sizes (every request pads up to its
    bucket), rounded up to ``align`` (and to ``dp``), deduplicated; the
    largest observed size always gets a bucket.

    >>> suggest_buckets([30, 60, 100, 500, 510, 520], max_buckets=4)
    [128, 512, 576]
    """
    if not sizes:
        return []
    a = math.lcm(align, max(1, dp))
    arr = np.sort(np.asarray(sizes))
    qs = np.linspace(1.0 / max_buckets, 1.0, max_buckets)
    return sorted({int(-(-int(np.quantile(arr, q, method="higher")) // a) * a) for q in qs})


class _Spec(NamedTuple):
    """What one program serves: its key among the captured graphs."""

    bucket: int
    sampler: str
    n_steps: Optional[int]       # DDIM's respaced steps; None for DDPM
    candidates: int              # best-of candidates (1: a single draw)
    skip: bool                   # every omega 0: the conditional half only
    eta: float
    renorm_steps: Optional[int]
    refine_iters: int            # projected-gradient steps after the decode
    refine_step: Optional[float]


class _Inputs(NamedTuple):
    """A program's inputs, on the device. A graph keeps one set and the
    request's data is copied into it."""

    cond: torch.Tensor           # (b, C) loader-normalized conditions
    cond_unnorm: torch.Tensor    # (b, C) in physical units
    valid: Optional[torch.Tensor]  # (b, 1) 1.0 real, 0.0 pad; None without buckets
    noise: torch.Tensor          # (candidates, b, columns, D), row-major
    omega: torch.Tensor          # (candidates,)


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: _Inputs
    out: torch.Tensor
    launches: Tuple[int, int]    # resblock and mega launches per replay


class Solver:
    """A task, a denoiser and its schedule, on one device.

    ``backend`` picks the denoiser forward: "fused" (residual blocks through
    the CUDA kernel), "mega" (the whole forward as one launch of the
    whole-network kernel) or "plain"; on the CPU the kernels' plain
    versions run.

    ``buckets``: optional batch sizes. A request of n rows is padded up to
    the smallest bucket that holds it by repeating its last row, and a
    (b, 1) validity mask keeps the pad rows out of the sampler's
    re-standardization and the decoder's batch-global reductions, so a
    bucketed answer equals an unbucketed one up to float reassociation. On
    a CUDA device each (bucket, configuration) runs as one captured CUDA
    graph (``graphs=False`` runs the same program eagerly). Without buckets
    every size runs eagerly with no mask.

    Noise is drawn from a generator seeded per request, row-major, for the
    n real rows only; pad rows get zeros. So a real row's noise does not
    depend on the bucket (``torch.randn`` of (b, ...) is not row-prefix
    stable).

    ``refine_iters`` > 0 polishes every decoded candidate with that many
    projected-gradient steps on the task objective
    (``tasks.base.refine_solutions``, first step ``refine_step`` or the
    task's), inside the same program, so a bucket's graph captures it. It is
    strictly per row, so padding stays exact; the first solve raises
    ValueError for a task without a projection (CO).

    ``mesh`` (a ``parallel.Mesh``; the sched on its device) spreads each
    request over the dp ranks, as the JAX package's meshed Solver does:
    every rank calls ``solve`` with the same conditions. The batch is padded
    to the next dp multiple (a configured bucket must be one) with masked
    rows, and a mask is always passed. Every rank draws the noise of the n
    real rows from the seed, as an unmeshed Solver does, and keeps its own
    rows; it samples and decodes its shard with the sampler's and decoders'
    batch-global reductions as all-reduces over dp (inside the bucket's
    graph on a card), and the decoded shards are gathered, so ``solve``
    returns the whole (n, D) on every rank. The parameters are placed by
    ``shard_params``: at ``tp > 1`` the wide kernels are split over tp,
    which only the "plain" backend runs ("fused" and "mega" take whole
    weight matrices and raise ValueError).
    """

    def __init__(self, task: Task, model: torch.nn.Module, sched: Schedule, config: Dict,
                 backend: str = "fused", buckets: Optional[Sequence[int]] = None,
                 graphs: bool = True, refine_iters: int = 0,
                 refine_step: Optional[float] = None, mesh: Optional[Mesh] = None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh, not {type(mesh).__name__}")
        self.task = task
        self.sched = sched
        self.config = dict(config)
        self.device = sched.betas.device
        self.mesh = mesh
        if mesh is not None:
            if mesh.device != self.device:
                raise ValueError(f"the schedule is on {self.device}, the mesh's device is "
                                 f"{mesh.device}")
            if mesh.tp > 1 and backend != "plain":
                raise ValueError(f"tp={mesh.tp} splits the wide kernels over tp, which the "
                                 f"{backend!r} backend does not run; use backend='plain'")
            model = shard_params(model, mesh)
        self.model = model
        self.buckets = sorted(int(b) for b in buckets) if buckets else None
        self.graphs = graphs
        self.refine_iters = int(refine_iters)
        self.refine_step = refine_step
        self._apply = unet_apply_fn(model, backend)
        self._D = task.data_dim(self.config)
        self._C = task.cond_dim(self.config)
        self._param = self.config.get("parameterization", "eps")
        #: Every program this Solver has run, and the graphs it captured.
        self.programs: set = set()
        self._graphs: Dict[_Spec, _Graph] = {}

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, task: str = "msr", device: DeviceLike = "cuda",
                        backend: str = "fused", dataset_config: Optional[Dict] = None,
                        buckets: Optional[Sequence[int]] = None, **kw) -> "Solver":
        """Load a ``diffsg_tpu.npz.v1`` checkpoint onto ``device`` (the
        mesh's device with a ``mesh``); ``kw`` goes to the constructor
        (``graphs``, ``refine_iters``, ``refine_step``, ``mesh``).
        ``dataset_config`` updates the checkpoint's recorded one.

        A multi-task face (``task="multi_<slot>"``) of a multi-task
        checkpoint starts from the checkpoint's ``subtask_configs[slot]``
        (``slot`` is the name after ``multi_``: ``nu_geo`` for
        ``multi_nu_geo``) and its shared architecture
        (``tasks.multi.merge_multi_config``)."""
        mesh = kw.get("mesh")
        dev = resolve_device(mesh.device if isinstance(mesh, Mesh) else device)
        ck = load_checkpoint(ckpt_dir, device=dev)
        md = ck["metadata"]
        config = dict(md.get("dataset_config") or {})
        if task.startswith("multi_") and "subtask_configs" in md:
            slot = task.split("_", 1)[1]
            config.update(md["subtask_configs"].get(slot) or {})
            merge_multi_config(config, md, slot)
        config.update(dataset_config or {})
        t = TASKS[task]
        return cls(t, loaded_model(t, ck["params"], config, dev), ck["sched"], config, backend,
                   buckets, **kw)

    @classmethod
    def from_torch_checkpoint(cls, pt_path: str, task: str, dataset_config: Dict,
                              device: DeviceLike = "cuda", backend: str = "fused",
                              buckets: Optional[Sequence[int]] = None, **kw) -> "Solver":
        """Load a reference torch DDPM checkpoint (``.pt``): its live
        ``model.*`` weights, not the EMA copy."""
        from .utils.torch_import import ddpm_from_torch

        dev = resolve_device(device)
        state, _, sched, _ = ddpm_from_torch(pt_path, device=dev)
        t = TASKS[task]
        model = t.build_model(dataset_config)
        model.load_state_dict(state, strict=True)
        return cls(t, model.to(dev).eval(), sched, dataset_config, backend, buckets, **kw)

    def _bucket(self, n: int) -> int:
        for b in self.buckets or ():
            if n <= b:
                return b
        return n  # larger than the biggest bucket (or no buckets): this size

    def warmup(self, omega=None, sizes: Optional[Sequence[int]] = None, sampler: str = "ddpm",
               n_steps: Optional[int] = None, best_of: int = 1,
               configs: Optional[Sequence[Dict]] = None) -> None:
        """Run (and on a card capture) the program of every bucket (or
        ``sizes``) for every configuration, through :meth:`solve` itself.
        ``configs`` is a list of ``solve`` keyword dicts, e.g. ``[{},
        {"best_of": 4, "omega": [150, 500, 2000, 5000]}, {"sampler": "ddim",
        "n_steps": 3}]``; without it, the one configuration the other
        arguments give."""
        cfgs = list(configs) if configs is not None else [
            {"omega": omega, "sampler": sampler, "n_steps": n_steps, "best_of": best_of}]
        for b in (sizes or self.buckets or ()):
            for cfg in cfgs:
                self.solve(np.zeros((b, self._C), np.float32), **cfg)

    @torch.inference_mode()
    def solve(self, X: np.ndarray, omega=None, best_of: int = 1, seed: int = 0,
              sampler: str = "ddpm", n_steps: Optional[int] = None, eta: float = 0.0,
              renorm_steps: Optional[int] = None, _block: bool = True):
        """Conditions (B, C), loader-normalized -> decoded solutions (B, D).

        omega: a scalar, or a list of per-candidate guidance scales (a
          mixture); default the task's.
        best_of: candidates per row with a scalar omega; a list omega has
          one candidate per entry. Each candidate is a whole draw, with its
          own batch-global statistics; the best by ``task.objective`` is
          kept per row (``select_best``). Candidate k's noise is the k-th
          draw from the seed's generator, so candidate 0 is the
          ``best_of=1`` draw.
        sampler: "ddpm" (the ancestral CFG sampler over all T steps) or
          "ddim" (over ``n_steps`` respaced steps, default T).
        eta / renorm_steps: DDIM only: its stochasticity, and the number of
          leading steps with batch re-standardization (default
          ``clamp(n // 5, 1, 4)``).

        A candidate's noise is drawn row-major: DDPM (n, T+1, D), column 0
        y_T and columns 1.. the per-step z; DDIM (n, 1, D), or (n, 1+s, D)
        with its s per-step noises when ``eta > 0``.

        _block: with False, return the (B, D) solutions on the device
          without waiting for them (the launches are asynchronous); a
          caller can issue several requests before it copies any result.
        """
        out = self._solve(X, omega, best_of, seed, sampler, n_steps, eta, renorm_steps)
        return out.cpu().numpy() if _block else out

    @torch.inference_mode()
    def solve_chunked(self, X: np.ndarray, chunk_size: int = 512, seed: int = 0,
                      **kw) -> np.ndarray:
        """Solve ``X`` in chunks of ``chunk_size`` rows, chunk j with seed
        ``seed + j`` and its own batch-global statistics, as serial
        ``solve`` calls do. Every chunk is issued before any result is
        copied to the host: CUDA launches are asynchronous, so the host
        prepares chunk j+1 while the card runs chunk j."""
        pending = [self._solve(X[i:i + chunk_size], seed=seed + j, **kw)
                   for j, i in enumerate(range(0, X.shape[0], chunk_size))]
        return np.concatenate([p.cpu().numpy() for p in pending])

    def _solve(self, X, omega=None, best_of: int = 1, seed: int = 0, sampler: str = "ddpm",
               n_steps: Optional[int] = None, eta: float = 0.0,
               renorm_steps: Optional[int] = None) -> torch.Tensor:
        """The decoded (n, D) solutions on the device, not yet copied."""
        if sampler not in ("ddpm", "ddim"):
            raise ValueError(f"unknown sampler {sampler!r}; use 'ddpm' or 'ddim'")
        if sampler == "ddpm" and (n_steps is not None or eta != 0.0 or renorm_steps is not None):
            raise ValueError("n_steps, eta and renorm_steps are DDIM options")
        omega = self.task.default_omega if omega is None else omega
        omegas = (np.full(best_of, omega, np.float32) if np.isscalar(omega)
                  else np.asarray(omega, np.float32))
        if omegas.ndim != 1 or omegas.size == 0:
            raise ValueError(f"omega must be a scalar or a non-empty list, got {omega!r}")
        X = np.asarray(X, np.float32)
        n = X.shape[0]
        b = self._bucket(n)
        mesh, rows = self.mesh, None
        if mesh is not None:
            # Only configured buckets must be dp multiples; larger sizes pad
            # up to the next one, as the JAX package's meshed Solver does.
            if self.buckets and b in self.buckets and b % mesh.dp != 0:
                raise ValueError(f"bucket {b} not divisible by dp={mesh.dp}; pick bucket "
                                 f"sizes that are multiples of the dp mesh size")
            b = -(-b // mesh.dp) * mesh.dp
            rows = mesh.rows(b)
        spec = _Spec(b, sampler, (n_steps or self.sched.T) if sampler == "ddim" else None,
                     omegas.size, bool(np.all(omegas == 0.0)), float(eta), renorm_steps,
                     self.refine_iters, self.refine_step)
        self.programs.add(spec)
        Xp = np.concatenate([X, np.repeat(X[-1:], b - n, axis=0)]) if b > n else X
        host = {"cond": Xp,
                "cond_unnorm": np.asarray(self.task.unnormalize_x(Xp, self.config), np.float32),
                "valid": ((np.arange(b) < n).astype(np.float32)[:, None]
                          if self.buckets or mesh is not None else None),
                "omega": omegas}
        if rows is not None:
            for name in ("cond", "cond_unnorm", "valid"):
                host[name] = host[name][rows]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if self.graphs and self.device.type == "cuda" and b in (self.buckets or ()):
            g = self._graphs.get(spec)
            if g is None:
                g = self._graphs[spec] = self._capture(spec, host, gen, n, rows)
            else:
                self._fill(g.inputs, host, gen, n, rows)
            g.graph.replay()
            resblock.LAUNCHES += g.launches[0]
            mega.LAUNCHES += g.launches[1]
            # A copy, so the next replay cannot overwrite a pending result.
            return g.out[:n].clone()
        inputs = self._alloc(spec, host["valid"] is not None)
        self._fill(inputs, host, gen, n, rows)
        return self._run(spec, inputs)[:n]

    # -- the program and its inputs -----------------------------------------------

    def _columns(self, spec: _Spec) -> int:
        if spec.sampler == "ddpm":
            return self.sched.T + 1
        return 1 + (len(respaced_steps(self.sched.T, spec.n_steps)) if spec.eta > 0 else 0)

    def _alloc(self, spec: _Spec, masked: bool) -> _Inputs:
        b, dev = spec.bucket // (self.mesh.dp if self.mesh else 1), self.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        return _Inputs(zeros(b, self._C), zeros(b, self._C), zeros(b, 1) if masked else None,
                       zeros(spec.candidates, b, self._columns(spec), self._D),
                       zeros(spec.candidates))

    def _fill(self, inputs: _Inputs, host: Dict, gen: torch.Generator, n: int,
              rows: Optional[slice] = None) -> None:
        """Copy a request into ``inputs`` and draw its noise: candidate by
        candidate, the n real rows from ``gen``; pad rows zero. On a mesh
        (``rows``, the rank's rows of the padded batch) each candidate's
        noise of all n rows is drawn, as without one, and the rank keeps
        its own rows."""
        for name in ("cond", "cond_unnorm", "valid", "omega"):
            dst = getattr(inputs, name)
            if dst is not None:
                src = torch.from_numpy(np.ascontiguousarray(host[name]))
                if dst.is_cuda:      # pinned, so the copy does not hold the host
                    src = src.pin_memory()
                dst.copy_(src, non_blocking=dst.is_cuda)
        lo, hi = (0, n) if rows is None else (rows.start, max(rows.start, min(rows.stop, n)))
        inputs.noise[:, hi - lo:].zero_()
        for k in range(inputs.noise.shape[0]):
            if rows is None:
                inputs.noise[k, :n].normal_(generator=gen)
            else:
                full = torch.empty((n, *inputs.noise.shape[2:]), dtype=inputs.noise.dtype,
                                   device=inputs.noise.device).normal_(generator=gen)
                inputs.noise[k, :hi - lo].copy_(full[lo:hi])

    def _run(self, spec: _Spec, inputs: _Inputs) -> torch.Tensor:
        """The program, on a mesh with its reductions over dp and the
        decoded shards gathered: (b, D) on every rank."""
        if self.mesh is None:
            return self._program(spec, inputs)
        with self.mesh.active():
            return all_gather_rows(self._program(spec, inputs), self.mesh)

    def _program(self, spec: _Spec, inputs: _Inputs) -> torch.Tensor:
        """Sample, decode, refine and (best-of) select: the work a graph
        captures."""
        decs, scores = [], []
        for k in range(spec.candidates):
            y0 = self._sample(spec, inputs, k)
            kw = {} if inputs.valid is None else {"valid_mask": inputs.valid}
            if self.task.decode_with_x is not None:
                dec = self.task.decode_with_x(y0, inputs.cond_unnorm, self.config, **kw)
            else:
                dec = self.task.decode(y0, self.config, **kw)
            if spec.refine_iters > 0:
                dec = refine_solutions(self.task, dec, inputs.cond_unnorm, self.config,
                                       spec.refine_iters, spec.refine_step)
            if spec.candidates == 1:
                return dec
            decs.append(dec)
            scores.append(self.task.objective(dec, inputs.cond_unnorm, self.config))
        return select_best(torch.stack(decs), torch.stack(scores), self.task.higher_is_better)

    def _sample(self, spec: _Spec, inputs: _Inputs, k: int) -> torch.Tensor:
        noise, omega = inputs.noise[k], inputs.omega[k]
        init = noise[:, 0].contiguous()
        rest = noise[:, 1:].transpose(0, 1)
        if spec.sampler == "ddim":
            return ddim_sample(self._apply, self.sched, inputs.cond, omega, self._D,
                               n_steps=spec.n_steps, eta=spec.eta, init_noise=init,
                               step_noise=rest if spec.eta > 0 else None,
                               renorm_steps=spec.renorm_steps, valid_mask=inputs.valid,
                               parameterization=self._param, skip_uncond=spec.skip)
        return cfg_sample(self._apply, self.sched, inputs.cond, omega, self._D,
                          init_noise=init, step_noise=rest, valid_mask=inputs.valid,
                          parameterization=self._param, skip_uncond=spec.skip)

    def _capture(self, spec: _Spec, host: Dict, gen: torch.Generator, n: int,
                 rows: Optional[slice] = None) -> _Graph:
        """Capture ``spec``'s program as a CUDA graph on inputs that hold
        this request. The program runs eagerly first, on a side stream
        (cuBLAS and the kernels' first-launch set-up happen outside the
        capture; three times where it refines, so that autograd's backward
        is warm too, as PyTorch's whole-network capture recipe does), and
        those launches count. Launches recorded during the
        capture do not run, so the wrappers keep them out of ``LAUNCHES``;
        their number is added per replay instead. On a mesh the graph
        captures the program's collectives too."""
        inputs = self._alloc(spec, masked=True)
        self._fill(inputs, host, gen, n, rows)
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(3 if spec.refine_iters > 0 else 1):
                self._run(spec, inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = (resblock.CAPTURED, mega.CAPTURED)
        try:
            with torch.cuda.graph(graph):
                out = self._run(spec, inputs)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture failed for {spec}: {e}") from e
        return _Graph(graph, inputs, out,
                      (resblock.CAPTURED - before[0], mega.CAPTURED - before[1]))
