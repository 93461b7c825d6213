"""Rank functions of the port's data-parallel tests: each runs in a
process spawned by :func:`repro_torch.launch.mesh.run_local_ranks` (one
rank of a gloo group, or NCCL on a card) and returns host data.

No jax here: ``tests/test_torch_cuda.py`` runs these on the card, where
there is none.  Inputs come in as numpy; the comparisons with the
reference are made by the test modules.
"""
import numpy as np
import torch

# the reduced DP runs: global batch, sequence, AdamW
DP_BATCH, DP_SEQ, DP_STEPS = 8, 16, 3
DP_OPT = dict(lr=3e-3, total_steps=10, warmup_steps=2)
# a gradient an ulp away from another run's can round to the next int8
# step of the compressed mean: at most this share of the elements may
# differ by such a step (tests/test_torch_dp_train.py)
FLIP_SHARE = 1e-3


def hold(got, want, atol, flip_atol, what, stats=None):
    """Two trees of arrays or tensors by path: every leaf within ``atol``
    but for at most FLIP_SHARE of all the elements, and those within
    ``flip_atol`` (each a number, or a function of the leaf's ``want``
    values as a numpy array).  The differences are taken in float64 with
    torch, on the device of ``want``'s leaf.  Returns how many elements lay past
    ``atol``; ``stats``, a dict, receives the largest difference and the
    number of elements."""
    moved, n_el, worst = 0, 0, 0.0
    assert sorted(got) == sorted(want), what
    at = lambda tol, w: tol(w.cpu().numpy()) if callable(tol) else tol
    for k, v in got.items():
        w = torch.as_tensor(want[k])
        d = (torch.as_tensor(v).to(w.device, torch.float64)
             - w.to(torch.float64)).abs_()
        lim, top = at(flip_atol, w), float(d.max())
        assert top <= lim, (what, k, top, lim)
        moved += int((d > at(atol, w)).sum())
        n_el, worst = n_el + d.numel(), max(worst, top)
    assert moved <= FLIP_SHARE * n_el, (what, moved, n_el)
    if stats is not None:
        stats.update(max_abs_diff=worst, elements=n_el)
    return moved


def _np(tree):
    from repro_torch.tree import flatten
    return {k: v.detach().cpu().numpy() for k, v in flatten(tree).items()}


def _to(arrays, device):
    return [torch.as_tensor(a).to(device) for a in arrays]


def _rank_tree(tree, r, device, bf16=()):
    """Row ``r`` of a tree of ``(n, ...)`` numpy arrays as tensors (the
    paths in ``bf16`` as bfloat16)."""
    from repro_torch.tree import map_with_path
    return map_with_path(lambda path, x: torch.tensor(x[r], device=device).to(
        torch.bfloat16 if path in bf16 else torch.float32), tree)


def _by_path(tree, tensors, period=1):
    """``tensors`` (one a tensor of ``tree``, in reference-leaf order) by
    path."""
    from repro_torch.distributed.collectives import _leaf_groups
    from repro_torch.tree import flatten
    path = {id(t): k for k, t in flatten(tree).items()}
    order = [t for grp in _leaf_groups(tree, period) for t in grp]
    return {path[id(t)]: x.cpu().numpy() for t, x in zip(order, tensors)}


def collectives_rank(mesh, grads, residuals, bf16, ef_steps):
    """For each group size ``n`` in ``grads`` (the first ``n`` ranks of
    the world, a new group each), row ``[rank]`` of the port-layout trees
    ``grads[n]`` / ``residuals[n]`` of ``(n, ...)`` arrays through
    ``tree_psum_compressed`` (the default buckets; its int32 sums kept),
    the same with 1 KiB buckets, ``psum_compressed_leaf`` on each
    non-layer leaf, ``tree_psum``, and ``quantize_int8_global`` of ``g +
    r``; at the largest ``n``, ``ef_steps`` steps of error feedback on
    leaf ``a``'s gradient.  Host arrays by path."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives as col
    from repro_torch.tree import flatten
    torch.set_num_threads(1)
    host = lambda tree: {k: v.float().cpu().numpy()
                         for k, v in flatten(tree).items()}
    out = {}
    for n in sorted(grads):
        group = dist.new_group(list(range(n)))
        if mesh.rank >= n:
            continue
        r, dev = mesh.rank, mesh.device
        g = lambda: _rank_tree(grads[n], r, dev, bf16)
        x = lambda: _rank_tree(residuals[n], r, dev)
        gt, sums = g(), []
        mean, new_r = col.tree_psum_compressed(gt, x(), group, sums=sums)
        res = {"mean": host(mean), "res": host(new_r),
               "dtype": {k: str(v.dtype) for k, v in flatten(mean).items()},
               "keys": (sorted(mean), len(mean["layers"])),
               "sums": _by_path(gt, sums)}
        small = []
        mb, rb = col.tree_psum_compressed(g(), x(), group, bucket_bytes=1024,
                                          sums=small)
        res["bucketed_equal"] = all(
            torch.equal(a, b) for t1, t2 in ((mb, mean), (rb, new_r))
            for a, b in zip(flatten(t1).values(), flatten(t2).values())
        ) and all(torch.equal(a, b) for a, b in zip(small, sums))
        g1, x1 = flatten(g()), flatten(x())
        qs = {k: col.quantize_int8_global(g1[k].float() + x1[k])
              for k in g1}
        res["q"] = {k: q.cpu().numpy() for k, (q, _) in qs.items()}
        res["smean"] = {k: float(col.mean_scale(s, group))
                        for k, (_, s) in qs.items()}
        res["leaf"] = {k: tuple(t.float().cpu().numpy() for t in
                                col.psum_compressed_leaf(g1[k], x1[k], group))
                       for k in g1 if not k.startswith("layers")}
        res["plain"] = host(col.tree_psum(g(), group))
        if n == max(grads):
            ga = flatten(g())["a"]
            xa = torch.zeros_like(ga, dtype=torch.float32)
            traj = []
            for _ in range(ef_steps):
                m, xa = col.psum_compressed_leaf(ga.clone(), xa, group)
                traj.append(m.cpu().numpy())
            res["ef_means"] = np.stack(traj)
        out[n] = res
    return out


def _dp_setup(arch, mesh, compress):
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import steps as st
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    data = SyntheticLM(vocab=cfg.vocab, seq_len=DP_SEQ, global_batch=DP_BATCH)
    step = st.make_dp_train_step(cfg, AdamWConfig(**DP_OPT), mesh,
                                 compress=compress)
    return cfg, data, step


def _step(step, state, data, i):
    tb = data.batch_at(i)
    state, m = step(state, {"tokens": tb.tokens, "labels": tb.labels})
    return state, float(m["loss"])


def _record(state, losses):
    return {"losses": losses, "params": _np(state.params),
            "residuals": None if state.residuals is None
            else _np(state.residuals), "step": int(state.opt.step)}


def dp_rank(mesh, arch, params, compress_modes, steps=DP_STEPS,
            sum_grads=None):
    """``steps`` steps of ``make_dp_train_step`` on reduced ``arch`` from
    ``params`` (flat port-layout numpy arrays) for each ``compress`` in
    ``compress_modes``: the losses, the final params and residuals; and the
    int32 sums of the compressed mean of ``sum_grads`` (flat numpy ``(n,
    ...)`` gradients, this rank's row) when given."""
    from repro_torch.distributed import collectives as col
    from repro_torch.models import family
    from repro_torch.optim import adamw_init
    from repro_torch.train import steps as st
    from repro_torch.tree import unflatten
    out = {}
    for compress in compress_modes:
        cfg, data, step = _dp_setup(arch, mesh, compress)
        template = family.init_params(cfg, 0, device="cpu")
        p = unflatten(template, {k: torch.tensor(v, device=mesh.device)
                                 for k, v in params.items()})
        state = st.TrainState(p, adamw_init(p), st.dp_residuals_init(
            p, mesh) if compress else None)
        losses = []
        for i in range(steps):
            state, loss = _step(step, state, data, i)
            losses.append(loss)
        out[compress] = _record(state, losses)
    if sum_grads is not None:
        sums = []
        gs = {k: torch.as_tensor(v[mesh.rank]).to(mesh.device)
              for k, v in sum_grads.items()}
        col.tree_psum_compressed(gs, col.zeros_residuals(gs), mesh.group,
                                 sums=sums)
        out["sums"] = [s.cpu().numpy() for s in sums]
    return out


def dp_rank_from(mesh, arch, starts):
    """One step from each reference state: ``starts[compress]`` lists the
    reference's flat train states (``(n, ...)`` residuals when
    compressed) before steps 0, 1, ...; each is carried into this rank's
    port state (``train_state_from_reference(rank=)``) and stepped on
    that step's batch.  Returns the records by mode, one a step."""
    from repro_torch.convert import train_state_from_reference
    out = {}
    for compress, flats in starts.items():
        cfg, data, step = _dp_setup(arch, mesh, compress)
        recs = []
        for i, flat in enumerate(flats):
            state = train_state_from_reference(flat, cfg, rank=mesh.rank,
                                               device=mesh.device)
            state, loss = _step(step, state, data, i)
            recs.append(_record(state, [loss]))
        out[compress] = recs
    return out


def elastic_rank(mesh, arch, params, global_batch):
    """The elastic re-mesh of a 4-rank data-parallel job: the plan from the
    live ``(4, 1)`` mesh down to 2 ranks, the new mesh (ranks 2 and 3 get
    none), a compressed train state resharded onto it (rank 0's values,
    each new rank the residuals of the old rank the plan gives it; every
    rank starts from different ones), then back up to 4 ranks (its
    residuals refused, the rest carried), the ``(2, 2)`` mesh
    ``make_local_mesh(2)`` places over the ranks, and the refusal of a
    plan with a model axis over ranks.  Host data."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import elastic
    from repro_torch.launch import mesh as pmesh
    from repro_torch.models import family
    from repro_torch.optim import adamw_init
    from repro_torch.train import steps as st
    from repro_torch.tree import flatten, tree_map, unflatten
    torch.set_num_threads(1)
    cfg = get_config(arch).reduced()
    template = family.init_params(cfg, 0, device="cpu")
    p = unflatten(template, {k: torch.tensor(v) for k, v in params.items()})
    if mesh.rank:                       # every other rank holds other values
        p = tree_map(lambda x: x + mesh.rank, p)
    state = st.TrainState(p, adamw_init(p), tree_map(
        lambda x: torch.full_like(x, float(mesh.rank + 1)), p))
    state.opt.step.fill_(3 + mesh.rank)
    for m in flatten(state.opt.mu).values():
        m.fill_(float(mesh.rank))
    out = {"shape": mesh.shape, "local": pmesh.make_local_mesh(
        device="cpu").shape}
    plan = elastic.plan_remesh(mesh, 2, global_batch=global_batch)
    out["plan"] = plan
    new = elastic.make_mesh_from_plan(plan, device="cpu")
    out["new"] = None if new is None else (
        new.shape, dist.get_world_size(new.group), new.rank)
    moved = elastic.reshard_state(state, cfg, new, plan=plan)
    if new is not None:
        out["moved"] = {"params": _np(moved.params), "mu": _np(moved.opt.mu),
                        "step": int(moved.opt.step),
                        "residuals": _np(moved.residuals)}
    back_plan = elastic.plan_remesh_shape(plan.axis_names, dict(zip(
        plan.axis_names, plan.new_shape)), 4, global_batch=global_batch)
    out["back_plan"] = back_plan
    back = elastic.make_mesh_from_plan(back_plan, device="cpu")
    src = moved if new is not None else state
    try:                                # residuals of 2 ranks do not split
        elastic.reshard_state(src, cfg, back, plan=back_plan)
        out["back_refused"] = None
    except ValueError as e:
        out["back_refused"] = str(e)
    out["back"] = _np(elastic.reshard_state(src._replace(residuals=None),
                                            cfg, back).params)
    pod = elastic.make_mesh_from_plan(elastic.RemeshPlan(
        (4,), (2, 2, 1), ("pod", "data", "model"), 1), device="cpu")
    out["pod"] = (pod.shape, dist.get_world_size(pod.group))
    out["pod_plan"] = elastic.plan_remesh(pod, 2, global_batch=global_batch)
    tp2 = pmesh.make_local_mesh(2, device="cpu")
    out["local_tp2"] = (tp2.shape, tp2.shard, tp2.replica)
    refusals = {}
    for name, call in (
            ("plan", lambda: elastic.make_mesh_from_plan(elastic.RemeshPlan(
                (4, 1), (2, 2), ("data", "model"), 1), device="cpu")),):
        try:
            call()
            refusals[name] = None
        except NotImplementedError as e:
            refusals[name] = str(e)
    out["refusals"] = refusals
    return out


def elastic_residuals_rank(mesh, arch, start, global_batch):
    """A compressed data-parallel job re-meshed from its 4 ranks, from the
    reference's state ``start`` (flat, ``(4, ...)`` residuals; this rank
    takes its row): for each new data degree in 2 and 1, the plan, the new
    mesh, the state resharded onto it (``carried``: the residuals each new
    rank holds) and one compressed step on it on batch 1.  Then the
    refusals of 4 -> 3 (a global batch of 12), 2 -> 4 and 1 -> 2: each
    the ``ValueError``'s message, or ``None``.  Host data by rank."""
    from repro_torch.convert import train_state_from_reference
    from repro_torch.distributed import elastic
    torch.set_num_threads(1)
    state = None
    out = {}
    for n in (2, 1):
        if state is None:
            state = train_state_from_reference(start, _dp_setup(
                arch, mesh, True)[0], rank=mesh.rank, device=mesh.device)
        plan = elastic.plan_remesh(mesh, n, global_batch=global_batch)
        new = elastic.make_mesh_from_plan(plan, device=mesh.device)
        cfg = _dp_setup(arch, mesh, True)[0]
        moved = elastic.reshard_state(state, cfg, new, plan=plan)
        if new is None:
            continue
        _, data, step = _dp_setup(arch, new, True)
        # copies: the step updates the residuals in place
        rec = {"carried": {k: v.copy() for k, v in
                           _np(moved.residuals).items()}}
        moved, loss = _step(step, moved, data, 1)
        rec.update(_record(moved, [loss]), mu=_np(moved.opt.mu),
                   nu=_np(moved.opt.nu))
        out[n] = rec
    refused = {}
    for name, old, n, batch in (("4->3", 4, 3, 12), ("2->4", 2, 4, 8),
                                ("1->2", 1, 2, 8)):
        plan = elastic.plan_remesh_shape(
            ("data", "model"), {"data": old, "model": 1}, n,
            global_batch=batch)
        new = elastic.make_mesh_from_plan(plan, device=mesh.device)
        try:
            elastic.reshard_state(state, cfg, new, plan=plan)
            refused[name] = None
        except ValueError as e:
            refused[name] = str(e)
    out["refused"] = refused
    return out


def failing_rank(mesh, message):
    """Raises on rank 1, as a rank that fails mid-run."""
    if mesh.rank == 1:
        raise RuntimeError(message)
    return mesh.rank


# mesh serving over ranks: the shards' ages (years), as the one-device
# mesh tests age them (tests/test_torch_mesh_common.py)
MESH_AGES = (1.5, 4.0, 6.5, 9.0)


def shard_fleet(tp, device, cfg=None):
    """A one-device fleet of ``tp`` shards aged MESH_AGES (cycled): the
    model's operator domains when ``cfg`` is given (the MoE router's)."""
    from repro_torch.core.fleet import FleetRuntime
    fleet = FleetRuntime.for_model(cfg, n_devices=1, n_shards=tp,
                                   device=device) if cfg is not None else \
        FleetRuntime(n_devices=1, n_shards=tp, device=device)
    for s in range(tp):
        fleet.set_age(years=MESH_AGES[s % len(MESH_AGES)], shard=s)
    return fleet


def mesh_serve_rank(mesh, jobs, dtype="float32"):
    """For each reduced arch of ``jobs`` (``{arch: {"params": flat
    port-layout numpy arrays of the whole tree, "runs": [...],
    "build_seed": int or None}}``), each run on a ``MeshServeEngine`` over
    ``make_serve_mesh(run["tp"])`` of this group (every rank runs every
    run): a shard fleet aged MESH_AGES (``run["fleet"]``: ``"plain"``,
    ``"model"`` for the model's domains, ``"runtime"`` for its shard 0's
    scalar BERs, ``None`` to serve clean), one ``generate``.  Returns per
    arch and run the tokens, this rank's shard and replica, its
    all-gathers, kernel launches, the bytes it holds and the specs; and
    with a
    ``build_seed``, this rank's leaves of ``init_mesh_params`` at ``tp =
    world``, by path (host arrays)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shrules
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models import family
    from repro_torch.serve.sharded import MeshServeEngine, init_mesh_params
    from repro_torch.tree import flatten, unflatten
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    out = {}
    for arch, job in jobs.items():
        cfg = get_config(arch).reduced()
        whole = unflatten(family.init_params(cfg, 0, device="cpu"), {
            k: torch.tensor(v) for k, v in job["params"].items()})
        recs = []
        for run in job["runs"]:
            m = make_serve_mesh(run["tp"], device=mesh.device)
            kind = run["fleet"]
            fleet = None if kind in (None, "runtime") else shard_fleet(
                run["tp"], mesh.device, cfg if kind == "model" else None)
            runtime = shard_fleet(1, mesh.device).device(0) \
                if kind == "runtime" else None
            eng = MeshServeEngine(cfg, whole, mesh=m, fleet=fleet,
                                  runtime=runtime, max_len=32,
                                  seed=run["seed"], serve_dtype=dt,
                                  use_fused_kernel=run["fused"],
                                  device=mesh.device)
            extras = {k: np.asarray(v)
                      for k, v in run.get("extras", {}).items()}
            kernels.reset_launch_counts()
            res = eng.generate(run["prompts"], run["n"],
                               **run.get("kw", {}), **extras)
            recs.append({"tokens": res.tokens, "shard": m.shard,
                         "replica": m.replica, "shape": m.shape,
                         "gathers": res.gathers,
                         "launches": kernels.launch_counts(),
                         "held_bytes": eng.held_bytes,
                         "specs": dict(_spec_items(eng.specs))})
        out[arch] = {"runs": recs}
        if job.get("build_seed") is not None:
            m = make_serve_mesh(device=mesh.device)
            built = init_mesh_params(cfg, m, job["build_seed"], dt)
            out[arch]["built"] = {k: shrules.held(v).cpu().numpy()
                                  for k, v in flatten(built).items()}
    return out


def _spec_items(specs, prefix=""):
    """``(path, spec)`` of a spec tree (its leaves are tuples)."""
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _spec_items(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            yield from _spec_items(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, specs


# tensor-parallel training over ranks (tests/test_torch_tp_train.py)
TP_OPT = dict(lr=3e-3, total_steps=10, warmup_steps=2)


def tp_train_rank(mesh, jobs, cli_argv=None):
    """For each job of ``jobs`` (``{"name", "arch", "replace": config
    fields replaced in the reduced config, "tp", "microbatches", "remat",
    "params": flat port-layout numpy arrays of the whole tree,
    "batches": [(tokens, labels), ...]}``): the mesh
    ``make_local_mesh(tp)`` of this group, the whole float32 state cut to
    this rank's blocks (``shard_train_state``), one
    ``make_train_step(mesh=)`` step a batch.  Per job the metrics and the
    collectives of each step, the mesh's shape, shard and replica, the
    ranks of its data group, the block of each leaf (``(dim, shard, tp)``
    or ``None``), this rank's replicated leaves after the steps, and, on
    shard 0 only, the state gathered back to whole
    (``gather_train_state``).  With ``cli_argv``, also the loss history
    of ``launch.train.main(cli_argv)`` on this rank, and the refusal of
    the same run with ``--ckpt-dir`` and no model axis (the message).
    Host data."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shrules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import family
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import steps as st
    from repro_torch.tree import flatten, unflatten
    torch.set_num_threads(1)
    out = {}
    for job in jobs:
        cfg = dataclasses.replace(get_config(job["arch"]).reduced(),
                                  **job["replace"])
        m = make_local_mesh(job["tp"], device=mesh.device)
        whole = unflatten(family.init_params(cfg, 0, torch.float32,
                                             device="cpu"), {
            k: torch.tensor(v, device=mesh.device)
            for k, v in job["params"].items()})
        state = st.shard_train_state(
            st.TrainState(whole, adamw_init(whole)), cfg, m)
        step = st.make_train_step(cfg, AdamWConfig(**TP_OPT), mesh=m,
                                  microbatches=job["microbatches"],
                                  remat=job["remat"])
        rec = {"shape": m.shape, "shard": m.shard, "replica": m.replica,
               "metrics": [], "collectives": []}
        rec["data_ranks"] = col.all_gather_cat(
            torch.tensor([mesh.rank]), 0, m.data_group or m.group).tolist()
        rec["blocks"] = {k: (v.dim, v.shard, v.tp) if isinstance(
            v, shrules.RankBlock) else None
            for k, v in flatten(state.params).items()}
        for tokens, labels in job["batches"]:
            col.reset_collective_counts()
            state, mets = step(state, {"tokens": tokens, "labels": labels})
            rec["collectives"].append(col.collective_counts())
            rec["metrics"].append({k: float(v) for k, v in mets.items()})
        rec["replicated"] = {k: v.numpy().copy() for k, v in
                             flatten(state.params).items()
                             if isinstance(v, torch.Tensor)}
        back = st.gather_train_state(state, m)
        if m.shard == 0:
            rec["whole"] = {name: {k: v.numpy() for k, v in flatten(
                tree).items()} for name, tree in (
                    ("params", back.params), ("mu", back.opt.mu),
                    ("nu", back.opt.nu))}
        out[job["name"]] = rec
    if cli_argv is not None:
        from repro_torch.launch import train
        out["cli"] = [h["loss"] for h in train.rank_main(mesh, cli_argv)]
        try:
            train.main(cli_argv[:-2] + ["--ckpt-dir", "unused"])
            out["cli_ckpt"] = None
        except NotImplementedError as e:
            out["cli_ckpt"] = str(e)
    return out
