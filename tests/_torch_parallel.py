"""Rank workers for the port's sequence, pipeline, expert and plan-engine
tests (``tests/test_torch_sequence.py``, ``test_torch_pipeline.py``,
``test_torch_expert.py``, ``test_torch_spmd.py``).

Imports neither JAX nor the JAX package: each worker runs as one gloo rank
started by ``tests/_torch_dist.run_ranks`` and returns numpy arrays.  A
worker builds the named mesh itself (``create_mesh`` is collective), runs
every case of its test in one spawn, and returns this rank's blocks.
"""
import numpy as np


def _t(a, grad=False):
    import torch
    x = torch.from_numpy(np.array(a))
    return x.requires_grad_(True) if grad else x


def _block(a, rank, world, axis):
    per = a.shape[axis] // world
    return np.take(a, range(rank * per, (rank + 1) * per), axis=axis)


# -- sequence parallelism ------------------------------------------------------

def sequence_cases(rank, world, data):
    """Each function case: this rank's sequence blocks of q/k/v (and the
    cotangent) through ring / Ulysses / Ulysses-flash over a ``seq`` mesh,
    the output and q/k/v gradients of sum(out * cot).  Each module case:
    ``SelfMultiheadAttn(impl=...)`` on this rank's (T_local, B, E) block,
    output and this rank's parameter gradients (their sum over ranks is the
    whole sequence's)."""
    import torch
    from apex_tpu_torch.contrib.multihead_attn import (SelfMultiheadAttn,
                                                       mha_params_from_jax)
    from apex_tpu_torch.parallel import (create_mesh, ring_attention,
                                         ulysses_attention,
                                         ulysses_flash_attention, use_mesh)
    fns = {"ring": ring_attention, "ulysses": ulysses_attention,
           "ulysses_flash": ulysses_flash_attention}
    mesh = create_mesh({"seq": world})
    out = {}
    with use_mesh(mesh):
        for name, causal, qk, kv in data["cases"]:
            q = _t(_block(data[qk][0], rank, world, 2), True)
            k = _t(_block(data[kv][1], rank, world, 2), True)
            v = _t(_block(data[kv][2], rank, world, 2), True)
            cot = _t(_block(data[qk][3], rank, world, 2))
            o = fns[name](q, k, v, axis_name="seq", causal=causal)
            (o * cot).sum().backward()
            out[(name, causal, qk, kv)] = (o.detach().numpy(),
                                           q.grad.numpy(), k.grad.numpy(),
                                           v.grad.numpy())
        mha = data["mha"]
        for impl, inner, causal in mha["cases"]:
            m = SelfMultiheadAttn(mha["E"], mha["H"], impl=impl,
                                  seq_inner_impl=inner, causal=causal,
                                  seq_parallel_axis=mesh.group("seq"),
                                  device="cpu")
            m.load_state_dict(mha_params_from_jax(mha["params"]))
            x = _t(_block(mha["x"], rank, world, 0), True)
            o, _ = m(x, is_training=False)
            (o * _t(_block(mha["cot"], rank, world, 0))).sum().backward()
            out[("mha", impl, inner, causal)] = (
                o.detach().numpy(), x.grad.numpy(),
                {n: p.grad.numpy() for n, p in m.named_parameters()})
    return out


def sequence_errors(rank, world):
    """The ragged-heads error from inside a collective call."""
    import torch
    from apex_tpu_torch.parallel import (SequenceShardingError, create_mesh,
                                         ulysses_attention, use_mesh)
    mesh = create_mesh({"seq": world})
    q = torch.ones(1, 5, 8, 4)
    with use_mesh(mesh):
        try:
            ulysses_attention(q, q, q)
        except SequenceShardingError as e:
            return str(e)
    return None


# -- pipeline parallelism ------------------------------------------------------

def pipeline_cases(rank, world, data):
    """Each case (M microbatches): ``pipeline_apply`` of a tanh stage over
    a ``pipe`` mesh of ``world`` stages, this rank holding stage ``rank``;
    the replicated output, this rank's stage gradients and the input's
    gradient of sum(out * cot) (counted once: only the last rank's loss is
    live, the others' masked)."""
    import torch
    from apex_tpu_torch.parallel import (create_mesh, pipeline_apply,
                                         stack_stage_params, unstack_local,
                                         use_mesh)

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    mesh = create_mesh({"pipe": world})
    stacked = stack_stage_params([{"w": _t(w), "b": _t(b)}
                                  for w, b in zip(data["w"], data["b"])])
    out = {}
    with use_mesh(mesh):
        for m in data["ms"]:
            local = {k: v[rank:rank + 1].clone().requires_grad_(True)
                     for k, v in stacked.items()}
            x = _t(data["x"][:m], True)
            y = pipeline_apply(stage_fn, unstack_local(local), x)
            live = torch.tensor(rank == world - 1)
            loss = (y * _t(data["cot"][:m])).sum()
            torch.where(live, loss, torch.zeros_like(loss)).backward()
            out[m] = (y.detach().numpy(), local["w"].grad[0].numpy(),
                      local["b"].grad[0].numpy(), x.grad.numpy())
        try:
            unstack_local({"w": stacked["w"][:2]})
            out["unstack_error"] = None
        except ValueError as e:
            out["unstack_error"] = str(e)
    return out


# -- expert parallelism --------------------------------------------------------

def expert_cases(rank, world, data):
    """``moe_ffn`` over an ``expert`` mesh of ``world`` ranks: this rank
    routes its token block over its expert shard; output, aux loss and the
    gradients (tokens, router, this rank's expert stacks) of sum(out * cot)
    + aux, plus the ep telemetry meter of each case.  Then the MoE model's
    loss and gradients, expert-sharded, when ``data["model"]`` is given."""
    import torch
    from apex_tpu_torch.models import (MoETransformerConfig,
                                       moe_params_from_jax,
                                       moe_transformer_loss)
    from apex_tpu_torch.parallel import create_mesh, moe_ffn, use_mesh
    from apex_tpu_torch.telemetry import events
    from apex_tpu_torch.telemetry.registry import MemorySink, Registry
    from apex_tpu_torch.utils.pytree import tree_flatten, tree_unflatten
    mesh = create_mesh({"expert": world})
    out = {}
    with use_mesh(mesh):
        for name, case in data["ffn"].items():
            e_local = case["w_in"].shape[0] // world
            x = _t(_block(case["x"], rank, world, 0), True)
            r = _t(case["router"], True)
            wi = _t(case["w_in"][rank * e_local:(rank + 1) * e_local], True)
            wo = _t(case["w_out"][rank * e_local:(rank + 1) * e_local], True)
            reg = Registry(sink=MemorySink(), flush_interval=0,
                           rank0_only=False)
            prev = events.set_default(reg)
            try:
                y, aux = moe_ffn(x, r, wi, wo, axis_name="expert",
                                 capacity_factor=case["cf"])
                ((y * _t(_block(case["cot"], rank, world, 0))).sum()
                 + aux).backward()
                vals = reg.read()
            finally:
                events.set_default(prev)
            out[name] = (y.detach().numpy(), float(aux), x.grad.numpy(),
                         r.grad.numpy(), wi.grad.numpy(), wo.grad.numpy(),
                         {k: v for k, v in vals.items()
                          if k.startswith("ep.")})
        model = data.get("model")
        if model is not None:
            cfg = MoETransformerConfig(**model["cfg"])
            params = moe_params_from_jax(model["params"], "cpu")
            e_local = cfg.num_experts // world
            for lyr in params["layers"]:
                for k in ("w_in", "w_out"):
                    lyr[k] = lyr[k][rank * e_local:(rank + 1) * e_local]
            leaves, td = tree_flatten(params)
            leaves = [p.clone().requires_grad_(True) for p in leaves]
            toks = _t(_block(model["tokens"], rank, world, 0)).long()
            loss = moe_transformer_loss(
                tree_unflatten(td, leaves), {"tokens": toks,
                                             "targets": toks}, cfg,
                expert_axis="expert")
            grads = torch.autograd.grad(loss, leaves)
            out["model"] = (float(loss), tree_unflatten(
                td, [g.numpy() for g in grads]))
    return out


# -- the plan engines ------------------------------------------------------------

def spmd_engine_cases(rank, world, cases, tokens_np, params_np, moe_np,
                      steps):
    """Each case: ``Plan(**knobs).apply()``, ``build_plan_step`` from the
    JAX weights (``moe_np`` for the ep family; ``"amp_dtype"`` passed
    through), ``steps`` steps on the same global tokens.  Returns per case
    the losses, the info (minus the callables), the telemetry meters of
    the first step, with ``"grads"`` the first step's gradients (before
    any dp reduction), with ``"step1_params"`` this rank's parameters
    after the first step, and the master's dtype."""
    import torch
    from apex_tpu_torch.models import moe_params_from_jax, params_from_jax
    from apex_tpu_torch.parallel import Plan, build_plan_step
    from apex_tpu_torch.parallel.plan import _flagship_cfg
    from apex_tpu_torch.telemetry import events
    from apex_tpu_torch.telemetry.registry import MemorySink, Registry
    cfg = _flagship_cfg(False)
    toks = torch.from_numpy(tokens_np.astype(np.int64))
    out = {}
    for name, case in cases.items():
        plan = Plan(**case["plan"])
        reg = Registry(sink=MemorySink(), flush_interval=0,
                       rank0_only=False)
        prev = events.set_default(reg)
        try:
            with plan.apply() as mesh:
                params = (moe_params_from_jax(moe_np, "cpu")
                          if plan.family == "ep"
                          else params_from_jax(params_np, "cpu"))
                carry, step, info = build_plan_step(
                    cfg, mesh, plan, global_batch=toks.shape[0],
                    params=params, device="cpu",
                    meter=case.get("meter", True),
                    amp_dtype=case.get("amp_dtype"))
                res = {}
                if case.get("grads"):
                    loss0, g = step.grads_of(carry[0], toks)
                    res["grads"] = (float(loss0), _np_tree(g))
                losses = []
                for i in range(steps):
                    carry, loss = step(carry, toks)
                    losses.append(float(loss))
                    if i == 0:
                        res["meters"] = {k: v for k, v in reg.read().items()
                                         if k.split(".")[0] in
                                         ("sp", "pp", "ep", "tp")}
                        if case.get("step1_params"):
                            res["step1_params"] = _np_tree(carry[0])
                res["losses"] = losses
                master = getattr(carry[1], "master", None)
                if master is not None:
                    res["master_dtype"] = str(master.dtype)
                res["info"] = {k: v for k, v in info.items()
                               if not callable(v)}
                if case.get("params"):
                    res["params"] = _np_tree(carry[0])
        finally:
            events.set_default(prev)
        out[name] = res
    return out


def _np_tree(tree):
    from apex_tpu_torch.utils.pytree import tree_map
    return tree_map(lambda t: t.detach().numpy(), tree)


def flagship_pair(rank, world, tokens_np, params_np, steps):
    """``build_plan_step(Plan(dp=world))`` and ``train.
    build_flagship_step`` from the same weights and tokens (this rank's
    rows for the latter): (losses, params) of each; the same for a zero1
    plan with an int8 parameter all-gather (``"ag_plan"``,
    ``"ag_flagship"``, and the fp32 all-gather's ``"zero1_plan"``), and
    the error of an all-gather scheme without a sharded update."""
    import torch
    from apex_tpu_torch.models import params_from_jax
    from apex_tpu_torch.parallel import Plan, build_plan_step
    from apex_tpu_torch.parallel.plan import _flagship_cfg
    from apex_tpu_torch.train import build_flagship_step
    cfg = _flagship_cfg(False)
    toks = torch.from_numpy(tokens_np.astype(np.int64))
    per = toks.shape[0] // world
    out = {}
    plan = Plan(dp=world)
    with plan.apply() as mesh:
        carry, step, info = build_plan_step(
            cfg, mesh, plan, global_batch=toks.shape[0],
            params=params_from_jax(params_np, "cpu"), device="cpu")
        losses = []
        for _ in range(steps):
            carry, loss = step(carry, toks)
            losses.append(float(loss))
        out["plan"] = (losses, _np_tree(carry[0]), info)
    carry, fstep = build_flagship_step(
        cfg, params=params_from_jax(params_np, "cpu"), device="cpu")
    losses = []
    for _ in range(steps):
        carry, loss = fstep(carry, toks[rank * per:(rank + 1) * per])
        losses.append(float(loss))
    out["flagship"] = (losses, _np_tree(carry[0]))

    def run(step, carry, local):
        losses = []
        for _ in range(steps):
            carry, loss = step(carry, toks[rank * per:(rank + 1) * per]
                               if local else toks)
            losses.append(float(loss))
        return losses, _np_tree(carry[0])

    for name, ag in (("zero1_plan", "fp32"), ("ag_plan", "int8_blockscale")):
        plan = Plan(dp=world, update_sharding="zero1", allgather_scheme=ag)
        with plan.apply() as mesh:
            carry, step, _ = build_plan_step(
                cfg, mesh, plan, global_batch=toks.shape[0],
                params=params_from_jax(params_np, "cpu"), device="cpu")
            out[name] = run(step, carry, False)
    carry, fstep = build_flagship_step(
        cfg, params=params_from_jax(params_np, "cpu"), device="cpu",
        ddp_kwargs=dict(update_sharding="zero1",
                        allgather_scheme="int8_blockscale"))
    out["ag_flagship"] = run(fstep, carry, True)
    plan = Plan(dp=world, allgather_scheme="int8_blockscale")
    try:
        with plan.apply() as mesh:
            build_plan_step(cfg, mesh, plan, global_batch=8, device="cpu")
        out["ag_error"] = None
    except ValueError as e:
        out["ag_error"] = str(e)
    plan = Plan(dp=world // 2, tp=2)
    with plan.apply() as mesh:
        carry, step, info = build_plan_step(
            cfg, mesh, plan, global_batch=toks.shape[0],
            params=params_from_jax(params_np, "cpu"), device="cpu")
        losses = run(step, carry, False)[0]
    out["tp_plan"] = (losses, info["engine"], info["tp"])
    return out


def mesh_cases(rank, world):
    """The mesh's layout and groups at world 4: a (2, 2) mesh's
    coordinates and group members, an all-reduce over each axis name, the
    -1 wildcard, Placement blocks and the resolver's errors."""
    import torch
    import torch.distributed as dist
    from apex_tpu_torch.parallel import mesh as M
    out = {}
    mesh = M.create_mesh({"data": 2, "seq": -1})
    out["shape"] = dict(mesh.shape)
    out["coords"] = dict(mesh.coords)
    out["members"] = {a: dist.get_process_group_ranks(mesh.group(a))
                      for a in mesh.axis_names}
    with M.use_mesh(mesh):
        out["bound"] = (M.axis_is_bound("seq"), M.axis_is_bound(("data",
                                                                 "seq")),
                        M.axis_is_bound("pipe"),
                        M.bound_axes("pipe", "seq", "data"))
        out["sizes"] = (M.axis_size("seq"), M.axis_size("pipe"),
                        M.lax_axis_size("data"))
        sums = {}
        for a in ("data", "seq"):
            t = torch.tensor([float(rank)])
            dist.all_reduce(t, group=M.resolve_group(a))
            sums[a] = float(t)
        out["sums"] = sums
        g = torch.arange(4 * 6).reshape(4, 6)
        out["local"] = (M.Placement(mesh, ("data", "seq")).local(g).numpy(),
                        M.data_sharding(mesh).local(g).numpy(),
                        M.replicated(mesh).local(g).numpy(),
                        M.Placement(mesh, (("data", "seq"),)).local(
                            g).numpy())
        try:
            M.resolve_group("pipe")
            out["unbound"] = None
        except NameError as e:
            out["unbound"] = str(e)
    out["no_mesh"] = M.current_mesh() is None and not M.axis_is_bound("seq")
    out["slices"] = M.num_slices()
    try:
        M.create_mesh({"data": 3})
        out["bad"] = None
    except ValueError as e:
        out["bad"] = str(e)
    return out


# -- tensor parallelism ----------------------------------------------------------

def tp_cases(rank, world, data):
    """At world 2 over a ``model`` mesh: (1) the pieces, each from this
    rank's Megatron shards of the JAX weights: the embedding's output and
    gradients of sum(out * cot), the head's whole logits (gathered) and
    gradients, the vocab-parallel cross-entropy's losses and logit
    gradients, the model's loss and gradients, and the conjugate
    operators' gradients; (2) serving: the tiny config's staggered
    requests through ``InferenceEngine(mesh=)`` and the unsharded engine
    at each O-level, greedy and sampled, and the fp32 engine's prefill and
    decode logits on fixed inputs."""
    import dataclasses
    import torch
    from apex_tpu_torch.models import (TransformerConfig, params_from_jax,
                                       tp_shard_params, transformer_loss)
    from apex_tpu_torch.models import transformer as tm
    from apex_tpu_torch.parallel import comm, create_mesh
    from apex_tpu_torch.serve import (CacheConfig, ContinuousBatcher,
                                      InferenceEngine, Request)
    from apex_tpu_torch.utils.pytree import tree_flatten, tree_unflatten
    mesh = create_mesh({"model": world})
    group = mesh.group("model")
    out = {}

    cfg = TransformerConfig(**data["cfg"])
    whole = params_from_jax(data["params"], "cpu")
    shards = tp_shard_params(whole, cfg, rank, world)
    leaves, td = tree_flatten(shards)
    leaves = [p.detach().clone().requires_grad_(True) for p in leaves]
    p = tree_unflatten(td, leaves)
    toks = _t(data["tokens"]).long()
    S = toks.shape[1]
    x = tm.embed(p, toks, p["embed"]["pos"][:S][None], cfg, group)
    (x * _t(data["cot"])).sum().backward()
    out["embed"] = (x.detach().numpy(), p["embed"]["tok"].grad.numpy(),
                    p["embed"]["ln_g"].grad.numpy())
    for l in leaves:
        l.grad = None
    h = _t(data["h"], True)
    logits = tm.head(p, h, cfg, group)
    (logits * _t(_block(data["cot_v"], rank, world, 2))).sum().backward()
    out["head"] = (comm.gather_from_tp(logits.detach(), group).numpy(),
                   h.grad.numpy(), p["embed"]["tok"].grad.numpy())
    for smoothing in (0.0, 0.1):
        z = _t(_block(data["logits"], rank, world, 1), True)
        loss = tm.vocab_parallel_xentropy(z, _t(data["labels"]).long(),
                                          group, smoothing)
        (loss * _t(data["g"])).sum().backward()
        out[("xent", smoothing)] = (loss.detach().numpy(), z.grad.numpy())
    for l in leaves:
        l.grad = None
    loss = transformer_loss(p, {"tokens": toks, "targets": toks}, cfg,
                            tp_group=group)
    grads = torch.autograd.grad(loss, leaves)
    out["model"] = (float(loss), _np_tree(tree_unflatten(td, list(grads))))
    a = _t(data["a"], True)
    (comm.reduce_from_tp(a * (rank + 1), group) * _t(data["a"])).sum() \
        .backward()
    b = _t(data["a"], True)
    (comm.copy_to_tp(b, group) * (rank + 1)).sum().backward()
    out["ops"] = (a.grad.numpy(), b.grad.numpy())

    scfg = TransformerConfig(**data["serve_cfg"])
    sparams = params_from_jax(data["serve_params"], "cpu")
    cache = CacheConfig(**data["cache"])
    for olevel in ("fp32", "bf16", "int8"):
        for sampled in (False, True):
            for name, m in (("tp", mesh), ("plain", None)):
                eng = InferenceEngine(sparams, scfg, cache=cache,
                                      olevel=olevel, decode_width=4,
                                      device="cpu", mesh=m)
                bat = ContinuousBatcher(eng)
                for spec in data["specs"][sampled]:
                    bat.submit(Request(**spec))
                res = bat.run()
                out[("serve", olevel, sampled, name)] = {
                    k: (r.status, r.tokens) for k, r in res.items()}
        eng = InferenceEngine(sparams, scfg, cache=cache, olevel=olevel,
                              decode_width=4, device="cpu", mesh=mesh)
        if olevel == "fp32":
            out["pool_shape"] = tuple(eng.k_pool.shape)
        logits = []
        cur, pos, tables = (np.array(v) for v in data["decode"])
        for plen, pages, tokens, seed in data["prefills"]:
            first, last = eng.prefill(np.array(tokens), plen,
                                      np.array(pages), seed=seed)
            logits.append(last.float().numpy())
        zeros = np.zeros(4, np.int64)
        for _ in range(3):
            tok, lg = eng.decode_step(cur, pos, tables, zeros,
                                      np.zeros(4, np.float32), zeros)
            logits.append(lg.float().numpy())
            cur[:2] = tok.numpy()[:2]
            pos[:2] += 1
        out[("logits", olevel)] = logits
    try:
        InferenceEngine(sparams, dataclasses.replace(scfg, num_heads=1),
                        cache=cache, device="cpu", mesh=mesh)
        out["heads_error"] = None
    except ValueError as e:
        out["heads_error"] = str(e)
    return out
