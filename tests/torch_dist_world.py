"""The gloo worlds of ``tests/test_torch_dist_serve.py``, run as one child
process:

    python tests/torch_dist_world.py <inputs.pt> <outputs.pt>

``inputs.pt`` holds the port's parameters of each smoke model (carried
over from the reference's with ``params_from_jax``), the prompt tokens
and the worlds to run, each a list of meshes over its ranks built one
after the other.  Each world is spawned on the CPU over gloo
(:func:`repro_torch.launch.world.spawn_world`); on each mesh of
``serve_meshes`` each rank cuts its blocks out of the full parameters,
serves the prompt through ``make_serve_steps(cfg, ProcessMesh(...))`` — a
prefill of the global batch, then greedy decode steps on its own rows —
and returns its logits, tokens and caches, each MoE rank also the
expert-parallel block's output on one input; the training step's refusal
of a family that serves over ``model`` but does not train there yet is
asked too.  A world of 1 also runs the unsharded path in the same
process, for a bitwise comparison.  On each mesh of ``fsdp_meshes`` each
rank serves each smoke family the job's ``fsdp_cases`` name for that mesh
twice, ``fsdp=False`` and ``fsdp=True`` (``FSDP_MIN_ELEMENTS`` lowered to
1), each drawing its blocks with ``model.init``, and returns whether the
logits agree bit for bit.  A model's ``batch`` (the vlm's and whisper's
context) goes with its prompt into every prefill.  Every rank's result goes to
``outputs.pt``.  It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import sys

import torch


def _serve(steps, params, batch, n_decode, s_max):
    _model, prefill, decode, _jit = steps
    lg, caches, pos = prefill(params, batch, s_max)
    logits, toks = [lg], []
    tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
    for _ in range(n_decode):
        toks.append(tok)
        tok, lg, caches, pos = decode(params, tok, caches, pos)
        logits.append(lg)
    return logits, toks + [tok], caches


def serve_rank(rank, shapes, job):
    """One rank of a world: each mesh of ``shapes`` over its ranks in turn
    (every rank builds them in one order: a mesh's groups are collective
    calls)."""
    from repro_torch.launch.mesh import ProcessMesh
    torch.set_num_threads(1)
    out = {}
    for sizes in map(tuple, shapes):
        mesh = ProcessMesh(*sizes)
        if sizes in map(tuple, job["serve_meshes"]):
            out[sizes] = mesh_rank(mesh, job)
        if sizes in map(tuple, job["fsdp_meshes"]):
            out[("fsdp",) + sizes] = fsdp_rank(mesh, job)
    return out


def fsdp_rank(mesh, job):
    """Each smoke family that runs on ``mesh`` served with ``fsdp=False``
    and ``fsdp=True``: whether the logits agree bit for bit, each rank's
    parameter elements under both, whether the fsdp blocks ``model.init``
    drew are the rank's blocks of the whole init, and whether the bound
    decode refuses whole parameters under fsdp."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TPL
    from repro_torch.models import build_model
    from repro_torch.models.layers import MetaGenerator
    from repro_torch.train import make_serve_steps
    from repro_torch.tree import leaves
    SH.FSDP_MIN_ELEMENTS = 1
    out = {}
    for arch, m in job["fsdp_models"].items():
        cfg = m["cfg"]
        if [*mesh.sizes, arch] not in map(list, job["fsdp_cases"]):
            continue
        B, s_max = m["tokens"].shape[0], m["s_max"]
        batch = {"tokens": m["tokens"]}
        ctx = {"context": m["context"]} if "context" in m else None
        batch.update(ctx or {})
        full = build_model(cfg)
        shapes = (full.init(MetaGenerator()),
                  full.init_cache(B, s_max, device="meta"),
                  torch.empty((B, 1), dtype=torch.int32, device="meta"))
        r, logits = {}, {}
        for fsdp in (False, True):
            model, prefill, _decode, jit_decode = make_serve_steps(
                cfg, mesh, fsdp=fsdp)
            params = model.init(torch.Generator().manual_seed(7))
            bound = jit_decode(*shapes)
            with torch.no_grad():
                lg, caches, pos = prefill(params, batch, s_max)
                got = [lg]
                tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
                for _ in range(job["n_decode"]):
                    tok, lg, caches, pos = bound(params, tok, caches, pos,
                                                 ctx)
                    got.append(lg)
            logits[fsdp] = got
            r[f"elements_{fsdp}"] = sum(t.numel() for t in leaves(params))
            if fsdp:
                whole = full.init(torch.Generator().manual_seed(7))
                r["init_blocks"] = all(torch.equal(a, b) for a, b in zip(
                    leaves(params), leaves(TPL.shard_tree(
                        whole, TPL.param_layout(whole, cfg, mesh, True),
                        mesh))))
                try:
                    jit_decode(*shapes)(whole, tok, caches, pos, ctx)
                    r["refused_whole"] = False
                except ValueError:
                    r["refused_whole"] = True
        r["bitwise"] = len(logits[True]) == len(logits[False]) and all(
            torch.equal(a, b) for a, b in zip(logits[True], logits[False]))
        out[arch] = r
    return out


def mesh_rank(mesh, job):
    """One rank's serving on a (data, model) mesh."""
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.distributed import tensor_parallel as TPL
    from repro_torch.distributed.moe_ep import make_moe_fn
    from repro_torch.models import build_model
    from repro_torch.train import make_serve_steps, make_train_step
    from repro_torch.tree import flatten
    out = {"coords": mesh.coords}
    for name, m in job["models"].items():
        cfg = m["cfg"]
        params = m["params"]
        batch = {"tokens": m["tokens"], **m.get("batch", {})}
        steps = make_serve_steps(cfg, mesh)
        local = TPL.shard_tree(params, TPL.param_layout(params, cfg, mesh),
                               mesh)
        bound = steps[3](params, build_model(cfg).init_cache(
            m["tokens"].shape[0], m["s_max"], device="meta"),
            torch.as_tensor(m["tokens"][:, :1]))
        try:
            bound(local, torch.as_tensor(m["tokens"][:, :1]),
                  build_model(cfg).init_cache(m["tokens"].shape[0],
                                              m["s_max"], device="cpu"),
                  torch.zeros(m["tokens"].shape[0], dtype=torch.int32))
            refused_whole_cache = mesh.size == 1
        except ValueError:
            refused_whole_cache = True
        with torch.no_grad():
            logits, toks, caches = _serve(
                (steps[0], steps[1], bound, None), local, batch,
                job["n_decode"], m["s_max"])
            r = {"logits": [t.clone() for t in logits], "tokens": toks,
                 "cache": {p: t.clone() for p, t in flatten(caches)},
                 "init_cache": {p: tuple(t.shape) for p, t in flatten(
                     steps[0].init_cache(m["tokens"].shape[0],
                                         m["s_max"]))},
                 "refused_whole_cache": refused_whole_cache}
            if "moe_x" in m:
                i = m["moe_layer"]
                moe_fn = make_moe_fn(cfg, mesh)
                r["moe_out"] = moe_fn(local["layers"][i]["ffn"],
                                      m["moe_x"], cfg)[0]
            if mesh.size == 1:
                plain, plain_toks, plain_cache = _serve(
                    make_serve_steps(cfg, None, "cpu"), params, batch,
                    job["n_decode"], m["s_max"])
                r["bitwise"] = all(
                    torch.equal(a, b) for a, b in zip(logits, plain)) and \
                    all(torch.equal(a, b) for a, b in zip(toks, plain_toks)) \
                    and all(torch.equal(a, b) for (_p, a), (_q, b) in zip(
                        flatten(caches), flatten(plain_cache)))
        out[name] = r
    if mesh.shape["model"] > 1:
        try:
            make_train_step(get_smoke_config("recurrentgemma-2b"),
                            TrainConfig(), mesh=mesh)
            out["refusal"] = None
        except ValueError as e:
            out["refusal"] = str(e)
    out["collectives"] = collectives_rank(mesh)
    return out


def collectives_rank(mesh):
    """Each collective over each named axis on values that name their
    sender: what every rank received."""
    from repro_torch.distributed import collectives as CL
    r = mesh.coords
    me = float(sum(r[a] * 10 ** i for i, a in enumerate(mesh.axis_names)))
    out = {}
    for axis in mesh.axis_names:
        n = mesh.shape[axis]
        x = torch.full((n, 3), me) + torch.arange(n)[:, None]
        out[axis] = {
            "all_to_all": CL.all_to_all(x, mesh, axis),
            "all_gather": CL.all_gather(torch.full((2, 1), me), mesh, axis,
                                        1),
            "psum": CL.psum(torch.full((4,), me, dtype=torch.bfloat16)
                            + torch.tensor([0, 1 / 256, 1 / 512, 0],
                                           dtype=torch.bfloat16), mesh, axis),
            "identity": CL.psum(x, mesh, axis) is x and
            CL.all_gather(x, mesh, axis) is x and
            CL.all_to_all(x, mesh, axis) is x}
    return out


def main(inputs, outputs):
    import math

    from repro_torch.launch.world import spawn_world
    job = torch.load(inputs, weights_only=False)
    results = {}
    for shapes in job["worlds"]:
        ranks = spawn_world(
            serve_rank, math.prod(shapes[0]), backend="gloo", device="cpu",
            args=(shapes, job), timeout_s=job["timeout_s"])
        for key in ranks[0]:
            results[key] = [r[key] for r in ranks]
    torch.save(results, outputs)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
