"""Rank workers for the PyTorch port's multi-process tests.

Imports neither JAX nor the JAX package, so a rank started with the
``spawn`` method loads only torch and the port.  :func:`run_ranks` starts
``world`` ranks on gloo, each rendezvousing through a ``FileStore`` under
the test's ``tmp_path`` (no network port: several pytest workers run at
once), runs ``fn(rank, world, *args)`` in each and returns their results
in rank order.  It joins the ranks against its own deadline and
terminates them when it passes, so a hung collective fails the test
instead of stalling the suite.  :func:`run_in_process` runs ``fn`` as the
only rank of a world-1 gloo group in the calling process.
"""
import multiprocessing as mp
import os
import queue
import time
import traceback

import numpy as np


def lr_decay(count):
    """An LR schedule both packages can evaluate on their step count."""
    return 1e-2 / count


LR_SCHEDULES = {"decay": lr_decay}


def _init(store_path, rank, world):
    from apex_tpu_torch.parallel import initialize_distributed
    initialize_distributed(init_file=store_path, rank=rank, world_size=world,
                           device="cpu")


def _worker(fn, rank, world, store_path, args, out):
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        _init(store_path, rank, world)
        try:
            res = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except Exception:                         # reported to the parent
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world, tmp_path, *args, deadline_s=150.0):
    """``fn(rank, world, *args)`` on ``world`` spawned gloo ranks; their
    results in rank order.  Raises on a rank's exception, a rank that dies
    without a result, or the deadline."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(os.fspath(tmp_path),
                         f"store-{fn.__name__}-{world}-{time.time_ns()}")
    procs = [ctx.Process(target=_worker, args=(fn, r, world, store, args,
                                               out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    end = time.monotonic() + deadline_s
    try:
        while len(results) + len(errors) < world:
            if time.monotonic() > end:
                raise TimeoutError(f"{fn.__name__}: {world} ranks did not "
                                   f"finish within {deadline_s:.0f} s")
            try:
                rank, ok, payload = out.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and out.empty():
                    time.sleep(1.0)           # a last result in flight
                    if out.empty():
                        raise RuntimeError(f"{fn.__name__}: a rank died "
                                           f"with exit codes {dead}")
                continue
            (results.__setitem__(rank, payload) if ok
             else errors.append(f"rank {rank}:\n{payload}"))
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world)]


def run_in_process(fn, tmp_path, *args):
    """``fn(0, 1, *args)`` as the one rank of a world-1 gloo group in this
    process; the group is destroyed afterwards."""
    import torch.distributed as dist
    _init(os.path.join(os.fspath(tmp_path), f"store-{time.time_ns()}"), 0, 1)
    try:
        return fn(0, 1, *args)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

def _groups(rank, world, topology):
    """(shard_group, replica_group, shard_rank).  "flat": one shard group
    of all ranks; "2x2": shard groups {0,1}, {2,3} and replica groups
    {0,2}, {1,3} (rank = replica * 2 + shard, the JAX (dcn, ici) mesh)."""
    import torch.distributed as dist
    if topology == "flat":
        return None, None, rank
    shard = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    replica = [dist.new_group([0, 2]), dist.new_group([1, 3])]
    return shard[rank // 2], replica[rank % 2], rank % 2


def zero_optimizer_cases(rank, world, cases, params_np, grads_np):
    """Each case: build the port's sharded optimizer, ``init`` from
    ``params_np`` and step over ``grads_np`` (a list, one dict of (world,
    *shape) local grads per step; this rank takes its row).  Returns, per
    case, the new params and this rank's state as numpy."""
    import torch
    from apex_tpu_torch.contrib.optimizers import (DistributedFusedAdam,
                                                   DistributedFusedLAMB)
    classes = {"adam": DistributedFusedAdam, "lamb": DistributedFusedLAMB}
    out = {}
    for case in cases:
        sg, rg, _ = _groups(rank, world, case.get("topology", "flat"))
        kw = dict(case["kw"])
        if kw.get("state_dtype") == "bfloat16":
            kw["state_dtype"] = torch.bfloat16
        if "lr" in case:
            kw["lr"] = LR_SCHEDULES[case["lr"]]
        opt = classes[case["opt"]](shard_group=sg, replica_group=rg, **kw)
        params = {k: torch.from_numpy(v.copy()) for k, v in params_np.items()}
        state = opt.init(params)
        res = opt.init_residual(params) if case.get("residual") else None
        scale = case.get("grad_scale", 1.0)
        reg = None
        if case.get("meter"):
            from apex_tpu_torch.telemetry import events
            from apex_tpu_torch.telemetry.registry import MemorySink, \
                Registry
            reg = Registry(sink=MemorySink(), flush_interval=0,
                           rank0_only=False)
            events.set_default(reg)
        try:
            for i, gl in enumerate(grads_np):
                g = {k: torch.from_numpy(v[rank] * scale)
                     for k, v in gl.items()}
                if case.get("poison_iter") == i and rank == 0:
                    g = {k: torch.full_like(v, float("inf"))
                         for k, v in g.items()}
                if res is None:
                    params, state = opt.step(state, g, params, scale=scale)
                else:
                    params, state, res = opt.step(state, g, params,
                                                  scale=scale, residual=res)
        finally:
            if reg is not None:
                events.set_default(None)
        out[case["name"]] = dict(
            params={k: v.numpy() for k, v in params.items()},
            p=state.p.numpy(), m=state.m.float().numpy(),
            v=state.v.float().numpy(), m_dtype=str(state.m.dtype),
            count=int(state.count), gnorm=float(state.gnorm),
            residual=None if res is None else res.numpy(),
            meters=None if reg is None else {
                k: v for k, v in reg.read().items()
                if k.startswith("zero.")})
    return out


def zero_train(rank, world, tree_np, cfg_kw, batches, opt_kw, split):
    """3 steps of ``zero_train_step`` from the JAX params ``tree_np``;
    this rank takes its contiguous rows of each global batch.  Returns
    (losses, this rank's master shard)."""
    import torch
    from apex_tpu_torch.contrib.multihead_attn import flash
    from apex_tpu_torch.contrib.optimizers import DistributedFusedLAMB
    from apex_tpu_torch.models import TransformerConfig, params_from_jax
    from apex_tpu_torch.train import zero_train_step
    cap = flash._FUSE_BUFFER_CAP_MB
    if split:
        flash._FUSE_BUFFER_CAP_MB = 0.0      # every backward takes the split
    try:
        cfg = TransformerConfig(**cfg_kw)
        params = params_from_jax(tree_np, device="cpu")
        opt = DistributedFusedLAMB(**opt_kw)
        state = opt.init(params)
        losses = []
        for b in batches:
            per = b["tokens"].shape[0] // world
            local = {k: torch.from_numpy(np.ascontiguousarray(
                v[rank * per:(rank + 1) * per]))
                for k, v in b.items()}
            local = {k: v.long() if v.dtype == torch.int32 else v
                     for k, v in local.items()}
            params, state, loss = zero_train_step(params, state, local, cfg,
                                                  opt)
            losses.append(float(loss))
    finally:
        flash._FUSE_BUFFER_CAP_MB = cap
    return losses, state.p.numpy()


def _rows(a, rank, counts):
    """This rank's rows of a global batch split into ``counts`` rows."""
    start = sum(counts[:rank])
    return np.ascontiguousarray(a[start:start + counts[rank]])


def syncbn_cases(rank, world, data):
    """The SyncBatchNorm and groupbn cases at world 2 over the default
    group, each on this rank's rows of the global numpy inputs in ``data``;
    returns {case: {name: numpy}}."""
    import torch
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.parallel import SyncBatchNorm, sync_batch_norm
    even = [data["x"].shape[0] // world] * world
    t = torch.from_numpy
    c = data["x"].shape[-1]
    w = t(data["w"]).requires_grad_(True)
    b = t(data["b"]).requires_grad_(True)
    out = {}
    for case, counts in (("nhwc", even), ("unequal", data["counts"])):
        x = t(_rows(data["x"], rank, counts)).requires_grad_(True)
        y, rm, rv = sync_batch_norm(x, w, b, torch.zeros(c), torch.ones(c))
        gx, gw, gb = torch.autograd.grad(
            (y * t(_rows(data["gy"], rank, counts))).sum(), (x, w, b))
        out[case] = dict(y=y, rm=rm, rv=rv, gx=gx, gw=gw, gb=gb)
    x = t(_rows(data["x"], rank, even)).requires_grad_(True)
    z = t(_rows(data["z"], rank, even))
    y, _, _ = sync_batch_norm(x, w, b, fuse_relu=True, z=z)
    gx, = torch.autograd.grad((y * t(_rows(data["gy"], rank, even))).sum(),
                              x)
    out["relu_z"] = dict(y=y, gx=gx)
    xc = t(_rows(data["x"], rank, even)).permute(0, 3, 1, 2)
    y, rm, rv = sync_batch_norm(xc, w, b, torch.zeros(c), torch.ones(c),
                                channel_last=False)
    out["nchw"] = dict(y=y.permute(0, 2, 3, 1), rm=rm, rv=rv)
    bn = SyncBatchNorm(c, affine=False, track_running_stats=False)
    y, _ = bn.apply({}, {}, x.detach(), training=False)
    out["eval_no_stats"] = dict(y=y)
    gbn = BatchNorm2d_NHWC(c, fuse_relu=True)
    params, state = gbn.init(device="cpu")
    y, st = gbn(params, state, x.detach(), z)
    out["groupbn"] = dict(y=y, rm=st["mean"], rv=st["var"])
    return {k: {n: v.detach().numpy() for n, v in d.items()}
            for k, d in out.items()}


def syncbn_grouped(rank, world, x_np):
    """World 4 in groups of 2: batch norm over this rank's group (the
    grouped mesh's ``group``, then groupbn's ``bn_group=2``), and the sum of
    the ranks over the ``data`` group."""
    import torch
    import torch.distributed as dist
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.parallel import create_grouped_mesh, sync_batch_norm
    mesh = create_grouped_mesh(2)
    x = torch.from_numpy(_rows(x_np, rank, [x_np.shape[0] // world] * world))
    y, _, _ = sync_batch_norm(x, None, None, axis_name=mesh.group)
    gbn = BatchNorm2d_NHWC(x.shape[-1], bn_group=2)
    params, state = gbn.init(device="cpu")
    y2, st = gbn(params, state, x)
    r = torch.tensor([float(rank)])
    dist.all_reduce(r, group=mesh.data)
    return dict(y=y.numpy(), y2=y2.numpy(), rm=st["mean"].numpy(),
                data_sum=float(r))


def ddp_cases(rank, world, grads_np, params_np):
    """DistributedDataParallel / Reducer / allreduce_tree over the default
    group on this rank's gradients (``grads_np`` leaves are (world, ...));
    returns {case: {leaf: numpy fp32}} and the broadcast params."""
    import torch
    from apex_tpu_torch.parallel import (DistributedDataParallel, Reducer,
                                         allreduce_tree)

    def local():
        g = {k: torch.from_numpy(v[rank].copy()) for k, v in grads_np.items()}
        g["b"] = g["b"].to(torch.bfloat16)
        return g

    def np32(tree):
        return {k: v.float().numpy() for k, v in tree.items()}

    ddp = DistributedDataParallel(device="cpu")
    out = {
        "average": ddp.allreduce_grads(local()),
        "one_bucket": DistributedDataParallel(
            delay_allreduce=True, device="cpu").allreduce_grads(local()),
        "small_buckets": DistributedDataParallel(
            message_size=40, overlap="bucketed",
            device="cpu").allreduce_grads(local()),
        "predivide": DistributedDataParallel(
            gradient_predivide_factor=2.0, allreduce_always_fp32=True,
            device="cpu").allreduce_grads(local()),
        "predivide_sum": DistributedDataParallel(
            gradient_predivide_factor=2.0, gradient_average=False,
            allreduce_always_fp32=True,
            device="cpu").allreduce_grads(local()),
        "tree_fp32": allreduce_tree(local(), always_fp32=True),
        "reducer_sum": Reducer(gradient_average=False).reduce(local()),
    }
    dtypes = {k: str(v.dtype) for k, v in out["predivide"].items()}
    params = {k: torch.from_numpy(v[rank].copy())
              for k, v in params_np.items()}
    return ({k: np32(v) for k, v in out.items()}, dtypes,
            {k: v.numpy() for k, v in ddp.broadcast_params(params).items()})


def resnet_ddp_steps(rank, world, params_np, state_np, batches, cfg_kw,
                     scale):
    """The ``--distributed --sync-bn`` step: amp O2 + FusedAdam(lr=1e-3),
    the dynamic scale started at ``scale``, ``resnet_train_step`` with a
    DistributedDataParallel over the default group on this rank's rows of
    each global batch.  Returns (losses averaged over the ranks, loss
    scales, the fp32 masters, the batch-norm state) as numpy."""
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.resnet import (ResNetConfig,
                                              resnet_params_from_jax)
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.train import resnet_train_step
    from apex_tpu_torch.utils.pytree import tree_leaves
    cfg = ResNetConfig(**cfg_kw)
    params, bn = resnet_params_from_jax(params_np, state_np, device="cpu")
    ddp = DistributedDataParallel(device="cpu")
    st = amp.initialize(ddp.broadcast_params(params), FusedAdam(lr=1e-3),
                        opt_level="O2", verbosity=0)
    st = st._replace(scalers=tuple(s._replace(loss_scale=torch.tensor(scale))
                                   for s in st.scalers))
    losses, scales = [], []
    for x, y in batches:
        counts = [x.shape[0] // world] * world
        st, bn, loss, _ = resnet_train_step(
            st, bn, torch.from_numpy(_rows(x, rank, counts)),
            torch.from_numpy(_rows(y, rank, counts)), cfg, ddp=ddp)
        dist.all_reduce(loss)
        losses.append(float(loss) / world)
        scales.append(float(st.loss_scale))
    masters = [t.detach() for t in tree_leaves(st.master_params)]
    masters = [(t.permute(2, 3, 1, 0) if t.dim() == 4 else t).numpy()
               for t in masters]
    return losses, scales, masters, [t.numpy() for t in tree_leaves(bn)]


def syncbn_empty_axis(rank, world, x_np):
    """``sync_batch_norm(..., axis_name=())`` on this rank's rows of
    ``x_np`` (NHWC) inside the initialised world: the output and the new
    running statistics, which must be this rank's own."""
    import torch
    from apex_tpu_torch.parallel import sync_batch_norm
    from apex_tpu_torch.parallel.mesh import resolve_group
    assert resolve_group(()) is None and resolve_group([]) is None
    x = torch.from_numpy(_rows(x_np, rank, [x_np.shape[0] // world] * world))
    c = x.shape[-1]
    out, rm, rv = sync_batch_norm(x, torch.ones(c), torch.zeros(c),
                                  torch.zeros(c), torch.ones(c),
                                  axis_name=(), training=True)
    return out.numpy(), rm.numpy(), rv.numpy()


def simple_ddp_steps(rank, world, params_np, X, Y, steps):
    """The toy example's O1 step (``simple_ddp_train_step``) on this
    rank's rows of the global batch, gradients averaged over the default
    group.  Returns (losses, loss scales, the fp32 params) as numpy."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.train import simple_ddp_train_step
    from apex_tpu_torch.utils.device import from_numpy
    counts = [X.shape[0] // world] * world
    x = from_numpy(_rows(X, rank, counts), "cpu")
    y = from_numpy(_rows(Y, rank, counts), "cpu")
    st = amp.initialize(from_numpy(params_np, "cpu"),
                        FusedSGD(lr=0.1, momentum=0.9), opt_level="O1",
                        verbosity=0)
    losses, scales = [], []
    try:
        for _ in range(steps):
            st, loss = simple_ddp_train_step(st, x, y, device="cpu")
            losses.append(float(loss))
            scales.append(float(st.loss_scale))
    finally:
        amp.uninit()
    params = {k: {n: t.numpy() for n, t in v.items()}
              for k, v in st.model_params.items()}
    return losses, scales, params


def sharded_ckpt_roundtrip(rank, world, path):
    """``save_sharded`` of a seeded tree (the same on every rank), then
    ``load_sharded`` into zeros; then the same after overwriting with
    another tree.  [first read back equal, second read back equal]."""
    import torch
    from apex_tpu_torch import checkpoint
    from apex_tpu_torch.optimizers.fused_adam import FusedAdamState
    from apex_tpu_torch.utils.pytree import tree_leaves

    def tree(seed):
        g = torch.Generator().manual_seed(seed)
        return {"w": torch.randn(8, 3, generator=g),
                "b": torch.randn(5, generator=g).bfloat16(),
                "opt": FusedAdamState(torch.tensor(seed, dtype=torch.int32),
                                      torch.randn(11, generator=g),
                                      torch.randn(11, generator=g),
                                      torch.randn(11, generator=g))}

    def zeros():
        return {"w": torch.zeros(8, 3), "b": torch.zeros(5).bfloat16(),
                "opt": FusedAdamState(torch.zeros((), dtype=torch.int32),
                                      torch.zeros(11), torch.zeros(11),
                                      torch.zeros(11))}

    out = []
    for seed in (1, 2):
        want = tree(seed)
        checkpoint.save_sharded(path, want)
        got = checkpoint.load_sharded(path, zeros())
        out.append(type(got["opt"]) is FusedAdamState and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(tree_leaves(got), tree_leaves(want))))
    return out


# ---------------------------------------------------------------------------
# collective schemes, overlap and weight-update sharding
# ---------------------------------------------------------------------------

def _np_tree(tree):
    return {k: v.detach().float().numpy() for k, v in tree.items()}


def collective_cases(rank, world, tree_np, res_np, flat_np, shard_np):
    """Every scheme through ``allreduce_tree``, the flat reduce-scatter and
    all-gather, the bucketed reduction and the zero1 chunked forms, on this
    rank's row of each (world, ...) input.  Returns {case: numpy}; the
    meters and the chaos gate's firings ride along."""
    import torch
    from apex_tpu_torch.parallel import collectives as C
    from apex_tpu_torch.parallel import overlap as O
    from apex_tpu_torch.parallel import allreduce_tree
    from apex_tpu_torch.resilience import faults
    from apex_tpu_torch.telemetry import events
    from apex_tpu_torch.telemetry.registry import MemorySink, Registry

    def local(tree):
        return {k: torch.from_numpy(v[rank].copy()) for k, v in tree.items()}

    out = {}
    for s in ("fp32", "bf16", "int8_blockscale", "adasum"):
        out[f"tree_{s}"] = _np_tree(allreduce_tree(
            local(tree_np), scheme=s, min_compress_bytes=0))
    red, res = allreduce_tree(local(tree_np), scheme="int8_blockscale",
                              residuals=local(res_np))
    out["tree_int8_res"], out["tree_int8_res_new"] = _np_tree(red), \
        _np_tree(res)
    out["tree_per_leaf"] = _np_tree(allreduce_tree(
        local(tree_np), scheme=lambda p, l: "int8_blockscale:min_bytes=0"
        if "b" in p else None, predivide_factor=2.0))
    flat = torch.from_numpy(flat_np[rank].copy())
    for s in ("fp32", "bf16", "int8_blockscale", "adasum"):
        shard, _ = C.reduce_scatter_flat(flat, None, C.resolve(s))
        out[f"rs_{s}"] = shard.numpy()
    shard, new_r = C.reduce_scatter_flat(
        flat, None, C.resolve("int8_blockscale"),
        residual=torch.from_numpy(flat_np[(rank + 1) % world] * 0.01))
    out["rs_int8_res"], out["rs_int8_res_new"] = shard.numpy(), \
        new_r.numpy()
    sh = torch.from_numpy(shard_np[rank].copy())
    for s in ("fp32", "bf16", "int8_blockscale"):
        full, wire, dt = C.allgather_flat(sh, None, C.resolve(s))
        out[f"ag_{s}"] = full.numpy()
        out[f"ag_{s}_wire"] = (wire, dt)
    # the bucketed path: fp32 / none bitwise the deferred one
    for name, s in (("none", None), ("fp32", "fp32"),
                    ("int8", "int8_blockscale:min_bytes=0")):
        out[f"bucketed_{name}"] = _np_tree(O.bucketed_allreduce(
            local(tree_np), scheme=s, message_size=700))
    red, res = O.bucketed_allreduce(local(tree_np),
                                    scheme="int8_blockscale:min_bytes=0",
                                    residuals=local(res_np),
                                    message_size=700)
    out["bucketed_int8_res"], out["bucketed_int8_res_new"] = \
        _np_tree(red), _np_tree(res)
    # zero1 chunked / segmented forms against the whole-buffer ones
    for s in ("fp32", "int8_blockscale"):
        spec = C.resolve(s)
        g, r, n = O.chunked_reduce_scatter(
            flat, None, spec, residual=torch.zeros_like(flat),
            message_size=128)
        whole, wr = C.reduce_scatter_flat(flat, None, spec,
                                          residual=torch.zeros_like(flat))
        out[f"chunked_{s}"] = (g.numpy(), r.numpy(), n,
                               bool(torch.equal(g, whole)),
                               bool(torch.equal(r, wr)))
        full, wire, dt, n = O.segmented_allgather(sh, None, spec,
                                                  message_size=128)
        wfull, _, _ = C.allgather_flat(sh, None, spec)
        out[f"segmented_{s}"] = (full.numpy(), wire, dt, n,
                                 bool(torch.equal(full, wfull)))
    # the meters
    reg = Registry(sink=MemorySink(), flush_interval=0, rank0_only=False)
    events.set_default(reg)
    try:
        allreduce_tree(local(tree_np), scheme="int8_blockscale:min_bytes=1024")
        O.bucketed_allreduce(local(tree_np), message_size=700)
        vals = reg.read()
    finally:
        events.set_default(None)
    out["meters"] = {k: v for k, v in vals.items()
                     if k.startswith("ddp.allreduce")}
    # the chaos gate: each scheme's reduction and the compressed flat
    # collectives raise on a collective_fail scheduled at their first call
    calls = {f"tree_{s}": (lambda s=s: allreduce_tree(
        local(tree_np), scheme=s, min_compress_bytes=0))
        for s in ("fp32", "bf16", "int8_blockscale", "adasum")}
    calls.update({f"rs_{s}": (lambda s=s: C.reduce_scatter_flat(
        flat, None, C.resolve(s))) for s in ("bf16", "int8_blockscale",
                                             "adasum")})
    calls["ag_int8_blockscale"] = lambda: C.allgather_flat(
        sh, None, C.resolve("int8_blockscale"))
    fired = {}
    for name, call in calls.items():
        prev = faults.install(faults.parse("collective_fail@0"))
        try:
            call()
            fired[name] = False
        except faults.CollectiveFault:
            fired[name] = True
        finally:
            faults.install(prev)
    out["chaos"] = fired
    return out


def tiny_transformer_cfg(**kw):
    from apex_tpu_torch.models import TransformerConfig
    base = dict(vocab_size=64, max_len=16, num_layers=1, d_model=32,
                num_heads=2, d_ff=64)
    base.update(kw)
    return TransformerConfig(**base)


def hooked_grad_cases(rank, world, params_np, tokens_np, cfg_kw):
    """``DistributedDataParallel.grad`` on a tiny transformer (remat, tied
    embedding) in both modes and against ``allreduce_grads`` of the plain
    backward's gradients; this rank takes its rows of ``tokens_np``.
    Returns the bitwise verdicts, the event log and the reduced grads."""
    import torch
    from apex_tpu_torch.models import transformer_loss
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.utils.device import from_numpy
    from apex_tpu_torch.utils.pytree import tree_flatten, tree_leaves, \
        tree_unflatten
    cfg = tiny_transformer_cfg(**cfg_kw)
    params = from_numpy(params_np, "cpu")
    per = tokens_np.shape[0] // world
    toks = torch.from_numpy(tokens_np[rank * per:(rank + 1) * per])
    batch = {"tokens": toks, "targets": toks}

    def fresh():
        leaves, td = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        return tree_unflatten(td, leaves), leaves, td

    out = {}
    for name, kw in (("off", {}),
                     ("bucketed", dict(overlap="bucketed", message_size=900)),
                     ("bucketed_int8", dict(
                         overlap="bucketed", message_size=900,
                         collective_scheme="int8_blockscale:min_bytes=0")),
                     ("off_int8", dict(
                         collective_scheme="int8_blockscale:min_bytes=0"))):
        ddp = DistributedDataParallel(device="cpu", **kw)
        tree, leaves, td = fresh()
        loss = transformer_loss(tree, batch, cfg)
        res = ddp.init_residuals(tree)
        grads, new_res = ddp.grad(loss, tree, residuals=res)
        tree2, leaves2, _ = fresh()
        raw = torch.autograd.grad(transformer_loss(tree2, batch, cfg),
                                  leaves2)
        ref, ref_res = ddp.allreduce_grads(tree_unflatten(td, list(raw)),
                                           residuals=res)
        eng = ddp.last_reduction
        out[name] = dict(
            grads=[g.numpy() for g in tree_leaves(grads)],
            same_as_allreduce_grads=all(
                torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                                  tree_leaves(ref))),
            same_residual=all(
                torch.equal(a, b) for a, b in zip(tree_leaves(new_res),
                                                  tree_leaves(ref_res))),
            events=None if eng is None else list(eng.events),
            launch_log=None if eng is None else list(eng.launch_log),
            buckets=None if eng is None else [list(b.leaf_ids)
                                              for b in eng.buckets])
    return out


def flagship_cases(rank, world, tokens_np, cfg_kw, steps, params_np):
    """``build_flagship_step`` in each DDP mode from the same weights
    (``params_np``, the JAX package's); this rank takes its rows of each
    global batch.  Returns {mode: (losses, params as numpy, the ddp.*
    meters)}."""
    import torch
    from apex_tpu_torch.models import params_from_jax
    from apex_tpu_torch.telemetry import events
    from apex_tpu_torch.telemetry.registry import MemorySink, Registry
    from apex_tpu_torch.train import build_flagship_step
    cfg = tiny_transformer_cfg(**cfg_kw)
    per = tokens_np.shape[1] // world
    modes = {
        "off": {},
        "bucketed": dict(overlap="bucketed", message_size=1000),
        "zero1": dict(update_sharding="zero1"),
        "zero1_bucketed": dict(update_sharding="zero1", overlap="bucketed",
                               message_size=256),
        "zero1_int8": dict(update_sharding="zero1",
                           collective_scheme="int8_blockscale:min_bytes=0",
                           allgather_scheme="int8_blockscale"),
    }
    out = {}
    for name, kw in modes.items():
        reg = Registry(sink=MemorySink(), flush_interval=0,
                       rank0_only=False)
        events.set_default(reg)
        try:
            carry, step = build_flagship_step(
                cfg, ddp_kwargs=kw, device="cpu",
                params=params_from_jax(params_np, "cpu"))
            losses = []
            for i in range(steps):
                toks = torch.from_numpy(
                    tokens_np[i, rank * per:(rank + 1) * per].copy())
                carry, loss = step(carry, toks)
                losses.append(float(loss))
            vals = reg.read()
        finally:
            events.set_default(None)
        out[name] = (losses, {g: {k: v.numpy() for k, v in leaves.items()}
                              for g, leaves in carry[0].items()},
                     {k: v for k, v in vals.items()
                      if k.startswith("ddp.")})
    return out


def sharded_optimizer_cases(rank, world, params_np, grads_np, cases):
    """Each case: ``ShardedUpdate`` over a fused optimizer (the port's
    ``step_flat_shard``) and the same optimizer's unsharded ``step_flat``
    on the reduced gradients, 3 steps; this rank takes its row of each
    (world, ...) gradient.  Returns (sharded params, unsharded params,
    residual facts) as numpy."""
    import torch
    from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB, \
        FusedNovoGrad
    from apex_tpu_torch.parallel import ShardedUpdate
    from apex_tpu_torch.resilience import faults
    classes = {"adam": FusedAdam, "lamb": FusedLAMB,
               "novograd": FusedNovoGrad}
    out = {}
    for case in cases:
        make = lambda: classes[case["opt"]](impl="fused", **case["kw"])
        params = {k: torch.from_numpy(v.copy()) for k, v in params_np.items()}
        su = ShardedUpdate(make(), **case.get("su", {}))
        st = su.init(params)
        res = su.init_residual(params) if case.get("residual") else None
        opt = make()
        fst = opt.init(params)
        ps, pu = params, params
        skipped_res = None
        for i, gl in enumerate(grads_np):
            g = {k: torch.from_numpy(v[rank].copy()) for k, v in gl.items()}
            if case.get("poison_iter") == i and rank == 0:
                g = {k: torch.full_like(v, float("inf")) for k, v in g.items()}
            if res is None:
                ps, st = su.step(st, g, ps)
            else:
                prev = res
                ps, st, res = su.step(st, g, ps, residual=res)
                if case.get("poison_iter") == i:
                    skipped_res = bool(torch.equal(prev, res))
            mean = {k: torch.from_numpy(v.mean(axis=0, dtype=np.float32))
                    for k, v in gl.items()}
            if case.get("poison_iter") != i:
                fl = opt.flattener_for(pu)
                fst = opt.step_flat(fst, fl.flatten(mean))
                pu = fl.unflatten(fst.master, like=pu)
        chaos = None
        if case.get("chaos"):
            prev_plan = faults.install(faults.parse("collective_fail@0"))
            try:
                su.step(st, g, ps, residual=res)
                chaos = False
            except faults.CollectiveFault:
                chaos = True
            finally:
                faults.install(prev_plan)
        out[case["name"]] = dict(
            sharded={k: v.numpy() for k, v in ps.items()},
            unsharded={k: v.numpy() for k, v in pu.items()},
            master_len=int(st.master.numel()), skipped_res=skipped_res,
            res_nonzero=None if res is None else bool(res.abs().sum() > 0),
            chaos=chaos)
    return out
