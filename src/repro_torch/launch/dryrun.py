"""Production-mesh dry run (the port's twin of the JAX package's
``launch/dryrun.py``): trace one step of every (architecture x input
shape x mesh) combination on the production mesh and record its
accounting and roofline terms.

For every combination this:
  1. builds the abstract parameters, optimizer state, cache and batch as
     ``meta`` tensors (``abstract_params``, ``abstract_cache``,
     ``registry.input_specs``) — nothing is allocated;
  2. resolves their shardings through the logical-axis rules
     (partitioning.py) and places them (``device_put``) as DTensors on the
     production mesh: a ``DeviceMesh`` of 256 or 512 ranks over a ``fake``
     process group, this process being rank 0 (no rank is started, nothing
     is sent);
  3. runs the step once on those DTensors, every kernel wrapper taking its
     ``meta`` path (shapes only), and counts what the step does on this
     rank: the kernel calls, the JAX package's Pallas grid steps, and every
     collective by JAX's HLO kind name with its bytes (the ``shard_map``
     bodies' own and those DTensor ops issue); a failure here (a sharding
     mismatch, an op with no DTensor rule) is a bug in the port;
  4. writes results/dryrun_torch/<arch>__<shape>__<mesh>.json, or a
     ``.fail`` file with the traceback of a case that raised.

The record has the JAX package's fields where the port has a twin:
``params``, ``analytic``, ``roofline`` (compute and memory from the
analytic model at the H100's peaks, the collective term from the counted
bytes by ``analysis.ici_seconds``: modelled, not measured),
``memory_analysis.argument_size_in_bytes`` (each argument's bytes on this
rank), ``sliding_window``; ``trace_s`` takes the place of ``lower_s`` and
``compile_s``.  XLA's HLO cost analysis has no twin (``cost_analysis_hlo``
is null, with the reason).

Usage:
  python -m repro_torch.launch.dryrun --device cpu          # all missing
  python -m repro_torch.launch.dryrun --device cpu --arch yi-9b \\
      --shape train_4k --mesh pod1 --force

The mesh's device type comes from ``--device``: ``cuda`` by default, which
raises without a card, or ``cpu``.  ``--jobs N`` runs N cases at a time
in N worker processes (each switching its fake group between 256 and 512
ranks as its cases need).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import analysis, kernels, steps
from repro_torch import partitioning as pt
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_arch, get_shape
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry, transformer
from repro_torch.optim.adamw import AdamW, tree_leaves

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
#: why the record's ``cost_analysis_hlo`` is null
NO_HLO = ("no XLA compile: the port traces the step on meta DTensors, so "
          "there is no HLO cost analysis; compute and memory come from the "
          "analytic model")
#: JAX's optimizer state holds its step counter as an int32 scalar on every
#: device; the port's is a Python int, counted at JAX's 4 bytes
STEP_BYTES = 4


def _batch_axes(cfg, shape, specs) -> dict:
    """Logical axes for each batch input."""
    sax = "seq_model" if cfg.seq_shard else "seq"
    axes = {}
    for name, s in specs.items():
        if name == "vis_embeds":
            axes[name] = ("batch", None, None)
        elif cfg.n_codebooks and s.dim() >= 2:
            axes[name] = ("batch", None, sax)[: s.dim()]
        else:
            axes[name] = ("batch", sax)[: s.dim()]
    return axes


def start_group(n_ranks: int) -> None:
    """Make this process rank 0 of a ``fake`` process group of
    ``n_ranks`` (collectives return at once and send nothing), ending a
    fake group of another size first.  A real group is left alone and
    must have ``n_ranks``."""
    if dist.is_initialized():
        if dist.get_world_size() == n_ranks:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} group of "
                               f"{dist.get_world_size()} ranks is running; "
                               f"the dry run needs {n_ranks}")
        dist.destroy_process_group()
    # registers the "fake" backend (PyTorch's own, for tracing SPMD
    # programs in one process)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)


def require(device: str) -> None:
    """Raise for a ``cuda`` mesh without a card: the tensors are meta
    either way, but the entry point runs on the card unless the caller
    asks for the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dry run's mesh is on cuda by default and "
                           "no CUDA device is here (pass device='cpu', "
                           "--device cpu)")


def build_case(arch: str, shape_name: str, multi_pod: bool,
               kv_quant: bool = False, data_axis: int = 16,
               model_axis: int = 16, device: str = "cuda"):
    """Returns (step, args, (cfg, shape, mesh, rules, meta)): ``step()``
    runs the case's step once on ``args``, the placed (params, optimizer
    state or cache, batch).  Needs a process group of the mesh's size
    (``start_group``)."""
    require(device)
    shape = get_shape(shape_name)
    cfg = registry.config_for_shape(get_arch(arch), shape)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    mesh = make_production_mesh(multi_pod=multi_pod, data=data_axis,
                                model=model_axis, device=device)
    # decode: no FSDP — re-gathering weight shards every token costs more
    # link traffic than the memory they save; weights stay model-sharded
    # and replicated over data
    overrides = {"embed": ()} if shape.kind == "decode" else None
    rules = pt.make_rules(mesh, overrides)

    params_abs, params_axes = transformer.abstract_params(cfg)
    params = pt.device_put(params_abs, pt.tree_shardings(
        params_axes, params_abs, rules))
    specs = registry.input_specs(cfg, shape)
    b_axes = _batch_axes(cfg, shape, specs)
    batch = {k: pt.device_put(s, rules.sharding_for(b_axes[k], s.shape))
             for k, s in specs.items()}

    if shape.kind == "train":
        for p in tree_leaves(params):
            p.requires_grad_()
        optimizer = AdamW(lr=3e-4)
        opt_state = optimizer.init(params)

        def step():
            return steps.train_step(optimizer, cfg, params, opt_state, batch)
        args = (params, opt_state, batch)
    else:
        cache_abs, cache_axes = transformer.abstract_cache(
            cfg, shape.global_batch, shape.seq_len)
        cache = pt.device_put(cache_abs, pt.tree_shardings(
            cache_axes, cache_abs, rules))
        fn = steps.prefill_step if shape.kind == "prefill" \
            else steps.decode_step

        def step():
            with torch.no_grad():
                return fn(cfg, params, cache, batch)
        args = (params, cache, batch)

    meta = {"arch": arch, "shape": shape_name,
            "mesh": "pod2" if multi_pod else "pod1",
            "n_chips": 512 if multi_pod else 256,
            "kind": shape.kind}
    return step, args, (cfg, shape, mesh, rules, meta)


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree`` (a DTensor
    counts its local shard)."""
    total = 0
    for t in analysis._tensors(tree):
        local = t.to_local() if hasattr(t, "to_local") else t
        total += local.numel() * local.element_size()
    return total


def _shape(t: torch.Tensor) -> list:
    """[global shape, dtype name] of a tensor."""
    return [list(t.shape), str(t.dtype).removeprefix("torch.")]


def accounting(cfg, shape, n_chips: int, coll_bytes: dict | None = None
               ) -> dict:
    """The record's model accounting: ``analytic`` (the itemized FLOPs and
    bytes of a global step), ``params`` (total, active) and ``roofline``
    (its three terms on ``n_chips`` H100s, the collective one from this
    rank's ``coll_bytes``)."""
    costs = analysis.analytic_costs(cfg, shape)
    roof = analysis.Roofline(
        flops=costs["flops"], hbm_bytes=costs["bytes"], n_chips=n_chips,
        model_flops=analysis.model_flops(cfg, shape),
        coll_bytes=coll_bytes or {})
    return {"analytic": costs, "params": analysis.param_counts(cfg),
            "roofline": roof.to_dict()}


def run_case(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             device: str = "cuda") -> dict:
    """Trace one case (the module's steps 1 to 4) and write its record;
    returns the record."""
    require(device)
    start_group(512 if multi_pod else 256)
    t0 = time.time()
    step, args, (cfg, shape, mesh, rules, meta) = build_case(
        arch, shape_name, multi_pod, device=device)
    # XLA's argument bytes leave out what the step never reads (jax.jit
    # drops unused arguments): ``labels``, which the loss takes from the
    # tokens themselves, and a prefill's cache position, which it only sets
    read = {k: v for k, v in args[2].items() if k != "labels"}
    state = args[1]
    if shape.kind == "prefill":
        state = {k: v for k, v in state.items() if k != "pos"}
    argument_bytes = local_bytes((args[0], state, read)) + (
        STEP_BYTES if shape.kind == "train" else 0)
    calls = dict(kernels.CALLS)
    result: dict = {}

    def traced():
        result["out"] = step()

    def counted():
        result["grid"] = analysis.count_pallas_grid_steps(traced)

    with pt.use_rules(rules):
        coll = analysis.count_collectives(counted)
    t_trace = time.time() - t0
    launches = {k: v - calls.get(k, 0) for k, v in kernels.CALLS.items()
                if v > calls.get(k, 0)}
    # what the step returns besides the trees it updates in place: a
    # training step's metrics, a prefill or decode step's logits
    if shape.kind == "train":
        outputs = {"metrics": {k: _shape(v) for k, v in
                               sorted(result["out"][2].items())}}
    else:
        outputs = {"logits": _shape(result["out"][0])}
    coll_bytes = {k: b for k, (_, b) in sorted(coll.items())}
    rec = dict(meta)
    rec.update(
        ok=True,
        trace_s=round(t_trace, 1),
        memory_analysis={"argument_size_in_bytes": argument_bytes},
        argument_bytes=argument_bytes,
        cost_analysis_hlo=None,
        cost_analysis_hlo_reason=NO_HLO,
        **accounting(cfg, shape, meta["n_chips"], coll_bytes),
        collective_bytes=coll_bytes,
        collective_calls={k: c for k, (c, _) in sorted(coll.items())},
        grid_steps=result["grid"],
        launches=launches,
        sliding_window=cfg.sliding_window,
        mesh_shape=dict(mesh.shape),
        outputs=outputs,
    )
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}__{shape_name}__{meta['mesh']}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _run_one(arch: str, shape_name: str, mesh_name: str, out_dir: str,
             device: str) -> tuple[bool, str]:
    """One case, its ``.fail`` file written where it raises: (ok, the
    summary line or the traceback)."""
    fname = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    try:
        rec = run_case(arch, shape_name, mesh_name == "pod2", out_dir,
                       device)
    except Exception:
        tb = traceback.format_exc()
        os.makedirs(out_dir, exist_ok=True)
        with open(fname + ".fail", "w") as f:
            f.write(tb)
        return False, tb
    if os.path.exists(fname + ".fail"):
        os.remove(fname + ".fail")
    r = rec["roofline"]
    return True, (f"   ok trace={rec['trace_s']}s dominant={r['dominant']} "
                  f"t=({r['t_compute_s']:.2e},{r['t_memory_s']:.2e},"
                  f"{r['t_collective_s']:.2e})s (modelled) "
                  f"useful={r['useful_flops_frac']:.2f} "
                  f"args/rank={rec['argument_bytes']:,}B "
                  f"collectives={rec['collective_bytes']}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=[None, *ARCHS])
    ap.add_argument("--shape", default=None, choices=[None, *INPUT_SHAPES])
    ap.add_argument("--mesh", default=None, choices=[None, "pod1", "pod2"])
    ap.add_argument("--out", default=os.path.normpath(RESULTS_DIR))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the mesh's device type (the tensors are meta)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cases at a time, in that many worker processes")
    ap.add_argument("--case", action="append", default=[],
                    metavar="ARCH,SHAPE,MESH",
                    help="one case (repeatable), in place of the "
                         "--arch/--shape/--mesh sweep")
    args = ap.parse_args(argv)
    require(args.device)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [args.mesh] if args.mesh else ["pod1", "pod2"]
    cases = []
    sweep = [tuple(c.split(",")) for c in args.case if c.count(",") == 2]
    if len(sweep) != len(args.case):
        ap.error("--case takes ARCH,SHAPE,MESH")
    sweep = sweep or [
        (arch, shape_name, mesh_name) for mesh_name in meshes
        for arch in archs for shape_name in shapes]
    for arch, shape_name, mesh_name in sweep:
        if arch not in ARCHS or shape_name not in INPUT_SHAPES \
                or mesh_name not in ("pod1", "pod2"):
            ap.error(f"--case {arch},{shape_name},{mesh_name}: unknown")
        fname = os.path.join(
            args.out, f"{arch}__{shape_name}__{mesh_name}.json")
        if os.path.exists(fname) and not args.force:
            print(f"skip {arch} {shape_name} {mesh_name} (done)")
            continue
        cases.append((arch, shape_name, mesh_name))

    failures = []

    def report(case, ok, text):
        print(f"== {' '.join(case)}", flush=True)
        print(text, flush=True)
        if not ok:
            failures.append(case)

    if args.jobs <= 1:
        for case in cases:
            report(case, *_run_one(*case, args.out, args.device))
    else:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=ctx) as pool:
            futures = {pool.submit(_run_one, *case, args.out, args.device):
                       case for case in cases}
            for fut in concurrent.futures.as_completed(futures):
                report(futures[fut], *fut.result())
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f_ in failures:
            print("  ", f_)
        raise SystemExit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
