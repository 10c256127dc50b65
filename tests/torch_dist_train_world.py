"""The gloo worlds of ``tests/test_torch_dist_train.py``, run as one child
process:

    python tests/torch_dist_train_world.py <inputs.pt> <outputs.pt>

``inputs.pt`` holds the port's parameters of each smoke model (carried
over from the reference's with ``params_from_jax``), the batches, the
training cases of each mesh, the gradients of the channel test and two
checkpoint directories.  Each world is spawned on the CPU over gloo
(:func:`repro_torch.launch.world.spawn_world`):

* the training worlds of 1, 2 and 4 ranks, each holding several meshes
  over its ranks, one after the other: (1, 1) and (pod, data, model)
  (1, 1, 1); (2, 1), (1, 2) and (2, 1, 1); (2, 2), (4, 1) and (2, 2, 1).
  On each mesh each rank cuts its blocks of the parameters, runs the
  mesh's cases through ``make_train_step(cfg, tcfg,
  mesh=ProcessMesh(...))`` (the first step through ``train_step`` on the
  global batch, the others through ``jit_train_step``'s bound step on the
  rank's rows) and returns its losses, grad norms, parameter and state
  blocks, and the first step's blocks of the dp-mean gradient (what the
  ZeRO plan's push hands the optimizer), and the ranks of its dp group;
  the world of 1 also runs the one-device step beside it, for a bitwise
  comparison, and saves a checkpoint that (2, 1) restores onto its
  blocks and saves again, which (2, 1, 1) restores and saves once more;
  (2, 2) also differentiates each collective, and (2, 2, 1) runs the
  collectives over the flattened ``("pod", "data")`` axes;
* a (pod, data, model) = (2, 2, 1) world runs the process gradient
  channel (``make_grad_sync``) on each rank's own gradients, exact and
  int8, under both fences;
* a world of 2 on (2, 1) runs ``run_elastic`` across processes: a failure
  at step 3 shrinks it to (1, 1), rank 1 leaves and rank 0 restores the
  checkpoint onto its new blocks and finishes; a second such world in
  which only rank 0 sees the failure and rank 1 goes without a word.

Every rank's result goes to ``outputs.pt``.  It imports neither JAX nor
the JAX package.
"""
from __future__ import annotations

import sys

import torch


def _cfg(case):
    from repro_torch.configs import MoEConfig, get_smoke_config
    cfg = get_smoke_config(case["arch"]).replace(dtype="float32")
    if cfg.moe is not None and case.get("moe"):
        cfg = cfg.replace(moe=MoEConfig(**case["moe"]))
    return cfg


def _tcfg(case):
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(lr=1e-3, zero_stage=case["stage"],
                       optimizer=case["optimizer"],
                       microbatch=case.get("microbatch", 0))


def _fsdp_threshold(case):
    from repro_torch.distributed import sharding as SH
    SH.FSDP_MIN_ELEMENTS = case.get("fsdp_min", 1 << 20)


def _blocks(tree):
    from repro_torch.tree import flatten
    return {p: t.detach().clone() for p, t in flatten(tree)}


def _whole_steps(case, params, batches):
    """The one-device step on the whole parameters: (losses, params,
    state)."""
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_map
    cfg, tcfg = _cfg(case), _tcfg(case)
    model, opt, step = make_train_step(cfg, tcfg, "cpu")
    params = tree_map(lambda t: t.clone(), params)
    state = opt.init(params)
    losses = []
    for b in batches:
        params, state, m = step(params, state, b)
        losses.append(m["loss"])
    return losses, params, state


def train_case(mesh, case, params, batches):
    """One case on this rank: its losses, grad norms and blocks; ``batches``
    the case's arch's."""
    from repro_torch.distributed import tensor_parallel as TPL
    from repro_torch.models import build_model
    from repro_torch.models.layers import MetaGenerator
    from repro_torch.models.model import param_stacks
    from repro_torch.optim import make_optimizer
    from repro_torch.train import make_train_step
    from repro_torch.tree import flatten
    _fsdp_threshold(case)
    cfg, tcfg = _cfg(case), _tcfg(case)
    model, opt, train_step, jit_train_step = make_train_step(cfg, tcfg,
                                                             mesh=mesh)
    full = build_model(cfg).init(MetaGenerator())
    layout = TPL.param_layout(full, cfg, mesh, tcfg.zero_stage >= 3)
    local = TPL.shard_tree(params, layout, mesh)
    state = opt.init(local)
    opt_shape = make_optimizer(tcfg, param_stacks(cfg)).init(full)
    bound = jit_train_step(full, opt_shape, {
        k: torch.empty(v.shape, dtype=torch.int32, device="meta")
        for k, v in batches[0].items()})
    from repro_torch.distributed import sharding as SH
    grads = {}
    push = opt.plan.grad_blocks

    def first_push(tree):
        """The plan's push, its first output (the first step's blocks of
        the dp-mean gradient) kept."""
        blocks = push(tree)
        if not grads:
            grads.update({p: b.detach().clone() for (p, _t), b in zip(
                flatten(tree), blocks)})
        return blocks

    opt.plan.grad_blocks = first_push
    losses, norms = [], []
    for i, b in enumerate(batches):
        if i == 0:
            local, state, m = train_step(local, state, b)
        else:
            rows = {k: SH.shard(torch.as_tensor(v), spec, mesh)
                    for (k, v), spec in zip(
                        b.items(), SH.batch_pspecs(b, mesh).values())}
            local, state, m = bound(local, state, rows)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    opt.plan.grad_blocks = push
    out = {"losses": losses, "grad_norms": norms, "params": _blocks(local),
           "state": _blocks(state), "grads": grads}
    if mesh.size > 1:
        fresh = jit_train_step(full, opt_shape, {
            k: torch.empty(v.shape, dtype=torch.int32, device="meta")
            for k, v in batches[0].items()})
        try:
            fresh(params, opt.init(params), batches[0])
            out["refused_whole"] = False
        except ValueError:
            out["refused_whole"] = True
    if tcfg.zero_stage >= 3:
        drawn = model.init(torch.Generator().manual_seed(5))
        whole = build_model(cfg).init(torch.Generator().manual_seed(5))
        out["init_blocks_equal"] = all(
            torch.equal(a, b) for a, b in zip(
                _blocks(drawn).values(),
                _blocks(TPL.shard_tree(whole, layout, mesh)).values()))
    return out, local, state


#: A checkpoint case's (directory it restores, its step; directory it
#: writes, its step): the world of 1 writes ``ckpt_a``, (2, 1) restores it
#: and writes ``ckpt_b``, (2, 1, 1) restores that and writes ``ckpt_c``.
CKPT = {"write": (None, ("ckpt_a", 1)),
        "reshard": (("ckpt_a", 1), ("ckpt_b", 2)),
        "pod": (("ckpt_b", 2), ("ckpt_c", 3))}


def mesh_rank(mesh, sizes, job):
    """This rank's cases on one mesh of its world."""
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import DP
    from repro_torch.train.train_step import state_shardings
    out = {"coords": mesh.coords, "cases": {},
           "dp_group": dist.get_process_group_ranks(mesh.group(DP))}
    for name, case in job["cases"].items():
        if tuple(case["mesh"]) != tuple(sizes):
            continue
        params = job["params"][case["arch"]]
        batches = job["batches"][case["arch"]]
        r, local, state = train_case(mesh, case, params, batches)
        if mesh.size == 1:
            losses, whole, whole_state = _whole_steps(case, params, batches)
            r["bitwise"] = all(torch.equal(a, b) for a, b in zip(
                r["losses"], losses)) and all(
                torch.equal(a, b) for a, b in zip(
                    r["params"].values(), _blocks(whole).values())) and all(
                torch.equal(a, b) for a, b in zip(
                    r["state"].values(), _blocks(whole_state).values()))
        if case.get("ckpt"):
            cfg, tcfg = _cfg(case), _tcfg(case)
            sh = state_shardings(cfg, tcfg, mesh)
            tree = {"params": local, "opt": state}
            source, (dest, step) = CKPT[case["ckpt"]]
            if source is not None:     # restored onto this mesh's blocks
                tree = CheckpointManager(job[source[0]]).restore(
                    source[1], tree, sh)
                r["restored"] = _blocks(tree)
            CheckpointManager(job[dest]).save(step, tree, shardings=sh)
        out["cases"][name] = r
    if tuple(sizes) == (2, 2):
        out["collectives"] = collective_grads(mesh, job["collectives"])
    if tuple(sizes) == (2, 2, 1):
        out["dp_collectives"] = dp_collectives(mesh)
    if tuple(sizes) == tuple(job["launch"]["mesh"]):
        out["launch"] = launch_rank(mesh, job)
    return out


def train_rank(rank, shapes, job):
    """One rank of a training world: each mesh of ``shapes`` over the
    world's ranks in turn (every rank builds them in one order: a mesh's
    groups are collective calls)."""
    from repro_torch.launch.mesh import ProcessMesh
    torch.set_num_threads(1)
    return {tuple(sizes): mesh_rank(ProcessMesh(*sizes), tuple(sizes), job)
            for sizes in shapes}


def dp_collectives(mesh):
    """The collectives over the flattened ``("pod", "data")`` axes on values
    that name their sender: a gather on dim 0 and on dim 1, a bf16 sum, a
    mean and the rank's own block of a reduce-scatter."""
    from repro_torch.distributed import collectives as CL
    from repro_torch.distributed.sharding import DP
    me = float(10 * mesh.coord("pod") + mesh.coord("data"))
    x = torch.full((2, 3), me)
    return {"index": mesh.coord(DP), "size": mesh.axis_size(DP),
            "gather0": CL.all_gather(x, mesh, DP, 0),
            "gather1": CL.all_gather(x, mesh, DP, 1),
            "psum": CL.psum(torch.full((4,), me, dtype=torch.bfloat16)
                            + torch.tensor([0, 1 / 256, 1 / 512, 0],
                                           dtype=torch.bfloat16), mesh, DP),
            "pmean": CL.pmean(torch.tensor([me]), mesh, DP),
            "reduce_scatter": CL.reduce_scatter(
                torch.arange(8.0) * (1 + me), mesh, DP, 0)}


def launch_rank(mesh, job):
    """``repro_torch.launch.train.run`` on the mesh: its losses and the
    steps it resumed from a checkpoint of its own world."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import train as launcher
    case = job["launch"]
    _fsdp_threshold(case)
    cfg, tcfg = _cfg(case), _tcfg(case)
    pipe = SyntheticTokens(cfg, 4, 16, seed=0)
    first = launcher.run(cfg, tcfg, pipe, steps=2, ckpt_dir=job["ckpt_launch"],
                         log_every=1, mesh=mesh)
    again = launcher.run(cfg, tcfg, pipe, steps=3,
                         ckpt_dir=job["ckpt_launch"], log_every=1, mesh=mesh)
    return {"losses": first["losses"] + again["losses"],
            "start": again["start"]}


def collective_grads(mesh, inp):
    """Each collective under autograd on this rank's share of seeded
    inputs: the gradients each rank gets."""
    from repro_torch.distributed import collectives as CL
    from repro_torch.distributed.sharding import shard
    c = mesh.coords
    x, w, cot = (inp[k].clone() for k in ("x", "w", "cot"))
    out = {}
    # row-parallel: x's columns and w's rows over model, the products summed
    xl = shard(x, (None, "model"), mesh).clone().requires_grad_(True)
    wl = shard(w, ("model", None), mesh).clone().requires_grad_(True)
    y = CL.psum(xl @ wl, mesh, "model")
    out["row"] = dict(zip(("x", "w"), torch.autograd.grad(
        (y * cot).sum(), (xl, wl))), y=y.detach())
    # column-parallel: the whole x in, w's columns over model, the outputs
    # gathered
    xf = x.clone().requires_grad_(True)
    wl = shard(w, (None, "model"), mesh).clone().requires_grad_(True)
    y = CL.all_gather(CL.copy_to(xf, mesh, "model") @ wl, mesh, "model", 1)
    out["column"] = dict(zip(("x", "w"), torch.autograd.grad(
        (y * cot).sum(), (xf, wl))), y=y.detach())
    # a slice over model and the gather back (the MoE block's x_spec)
    xf = x.clone().requires_grad_(True)
    y = CL.all_gather(CL.slice_to(xf, mesh, "model", 0).square(), mesh,
                      "model", 0)
    out["slice"] = dict(x=torch.autograd.grad((y * cot[:, :x.shape[1]])
                                              .sum(), xf)[0])
    # all_to_all over data: block j of each rank to coordinate j
    xa = (x[:2] + 10 * c["data"] + 100 * c["model"]).requires_grad_(True)
    y = CL.all_to_all(xa, mesh, "data")
    out["a2a"] = dict(y=y.detach(), x=torch.autograd.grad(
        (y * cot[:2, :x.shape[1]]).sum(), xa)[0])
    # fsdp: w's rows over data, gathered whole; each data rank's loss on
    # its own rows of x
    wl = shard(w, ("data", None), mesh).clone().requires_grad_(True)
    xr = shard(x, ("data", None), mesh)
    y = xr @ CL.gather_param(wl, mesh, "data", 0)
    out["fsdp"] = dict(w=torch.autograd.grad((y * shard(
        cot, ("data", None), mesh)).sum(), wl)[0])
    # a loss term's mean over the world
    v = (x[0, 0] * (1 + c["data"] + 2 * c["model"])).requires_grad_(True)
    m = CL.loss_mean(v, mesh, 2)
    out["loss_mean"] = dict(y=m.detach(), x=torch.autograd.grad(m, v)[0])
    return out


def grad_sync_rank(rank, job):
    """The process gradient channel on a (pod, data, model) = (2, 2, 1)
    mesh, each rank's gradients its own draw."""
    from repro_torch.distributed.collectives import make_grad_sync
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.optim.compression import int8_payload_process
    from repro_torch.tree import tree_map
    torch.set_num_threads(1)
    mesh = ProcessMesh(2, 2, 1)
    p, d = mesh.coord("pod"), mesh.coord("data")
    grads = tree_map(lambda g: g[p, d].clone(), job["grads"])
    out = {"coords": mesh.coords}
    for fence in ("global", "pair"):
        for compress in ("none", "int8ef"):
            sync = make_grad_sync(mesh, fence=fence, compress=compress)
            first = sync(grads)
            out[(fence, compress)] = [first, sync(grads)]
    # the int8 payload of the first call's pod hop
    from repro_torch.distributed.collectives import pmean
    payload = {}
    for k, g in (("w", grads["w"]),):
        q, scale = int8_payload_process(pmean(g.float(), mesh, "data"),
                                        mesh, "pod")
        payload[k] = (q, scale)
    out["payload"] = payload
    return out


class _Gone(Exception):
    """This rank left its world without a word."""


def elastic_rank(rank, job, silent=False):
    """``run_elastic`` across processes: (2, 1), then (1, 1).  With
    ``silent`` only rank 0 sees the failure: rank 1 leaves at the failed
    step without a word (its sockets closed, no collective, no
    ``shrink_world``), as a rank that died would."""
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import ElasticMeshSpec, run_elastic
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import state_shardings
    from repro_torch.tree import tree_map
    torch.set_num_threads(1)
    case = job["elastic"]
    cfg, tcfg = _cfg(case), _tcfg(case)
    batches = job["batches_elastic"]
    ckpt = CheckpointManager(job["ckpt_elastic_silent" if silent else
                                 "ckpt_elastic"], keep_last=2)
    spec = ElasticMeshSpec(shapes=[(2, 1), (1, 1)],
                           axis_names=("data", "model"), binding="process")
    meshes, losses = [], []

    def build(mesh):
        meshes.append(dict(mesh.shape))
        model, opt, train_step, _jit = make_train_step(cfg, tcfg, mesh=mesh)
        from repro_torch.distributed import tensor_parallel as TPL
        params = TPL.shard_tree(job["params"][case["arch"]],
                                TPL.param_layout(
                                    job["params"][case["arch"]], cfg, mesh),
                                mesh)
        state = {"params": params, "opt": opt.init(params)}

        def step_fn(state, batch):
            p, o, m = train_step(state["params"], state["opt"], batch)
            losses.append((len(meshes) - 1, float(m["loss"])))
            return {"params": p, "opt": o}, m

        return state, step_fn, lambda m: state_shardings(cfg, tcfg, m)

    def get_batch(s):
        if silent and rank == 1 and s == 3:
            dist.destroy_process_group()
            raise _Gone
        return batches[s]

    mesh = spec.mesh_for(0)
    state, step_fn, shard_fn = build(mesh)
    for s in range(2):
        state, _m = step_fn(state, batches[s])
    ckpt.save(1, state, shardings=shard_fn(mesh))
    try:
        final, history = run_elastic(
            spec, build, ckpt, total_steps=5, get_batch=get_batch,
            inject_failure_at={3: True} if rank == 0 or not silent else {},
            log=lambda *_a: None)
    except _Gone:
        return {"gone": True, "losses": losses}
    return {"history": history, "meshes": meshes, "losses": losses,
            "left": final is None,
            "final": None if final is None else tree_map(
                lambda t: t.detach().clone(), final["params"])}


def main(inputs, outputs):
    import math

    from repro_torch.launch.world import spawn_world
    job = torch.load(inputs, weights_only=False)
    results = {}
    for shapes in job["worlds"]:
        ranks = spawn_world(
            train_rank, math.prod(shapes[0]), backend="gloo", device="cpu",
            args=(shapes, job), timeout_s=job["timeout_s"])
        for sizes in shapes:
            results[tuple(sizes)] = [r[tuple(sizes)] for r in ranks]
    results["grad_sync"] = spawn_world(
        grad_sync_rank, 4, backend="gloo", device="cpu", args=(job,),
        timeout_s=job["timeout_s"])
    results["elastic"] = spawn_world(
        elastic_rank, 2, backend="gloo", device="cpu", args=(job,),
        timeout_s=job["timeout_s"])
    results["elastic_silent"] = spawn_world(
        elastic_rank, 2, backend="gloo", device="cpu", args=(job, True),
        timeout_s=job["timeout_s"])
    torch.save(results, outputs)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
