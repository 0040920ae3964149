"""The port's mesh (mmgl_tpu_torch/parallel/) against the JAX package's and
against its own one-rank runs, on the CPU over gloo.

One group of ranks is spawned for each mesh shape, (1, 2), (2, 2) and
(4, 1), each rank a process on one intra-op thread; it runs every check of
that shape (``TASKS``) and writes what it found, which the tests read. The
rule table is held against ``mmgl_tpu.parallel.param_shardings`` in this
process, on the JAX conftest's 8 host devices. Each test states its
tolerance: fp32 throughout, dropout off (the tiny models have none), so the
ranks and one rank differ only by the order of their sums.
"""

import copy
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mmgl_tpu_torch import cli
from mmgl_tpu_torch.parallel.collectives import VocabShard
from mmgl_tpu_torch.parallel.mesh import Mesh, make_mesh, param_specs

TINY = ["--device", "cpu", "--max_input_length", "32",
        "--max_output_length", "16", "--max_text_neighbors", "3",
        "--max_image_neighbors", "2", "--n_text_tokens", "2",
        "--n_visual_tokens", "2", "--per_device_train_batch_size", "2",
        "--per_device_val_batch_size", "2", "--grad_accumulation_steps",
        "2", "--learning_rate", "1e-3", "--lr_warmup_steps", "1",
        "--grad_clip", "0.5", "--seed", "0", "--dataloader_num_workers", "1",
        "--prefetch_batches", "2"]
OPT_ARGV = ["--model_name_or_path", "opt-tiny", "--context", "all"] + TINY
LORA_ARGV = ["--model_name_or_path", "opt-tiny", "--context", "text_only",
             "--neighbor_mode", "embedding", "--peft_type", "lora",
             "--lora_r", "4"] + TINY
T5_ARGV = ["--model_name_or_path", "t5-tiny", "--context", "all"] + TINY
# BASELINE family 5 (tests/test_baseline_configs.py, "opt-laplacian-prefix-
# meshed"), with that test's flags
FAMILY5 = dict(model_name_or_path="opt-tiny", context="all",
               neighbor_mode="embedding", peft_type="prefix",
               position_type="laplacian", max_input_length=32,
               max_output_length=16, max_text_neighbors=3,
               max_image_neighbors=2, n_text_tokens=2, n_visual_tokens=2,
               per_device_train_batch_size=2, per_device_val_batch_size=2,
               epochs=1, steps_per_epoch=2, val_steps_per_epoch=1,
               grad_accumulation_steps=1, print_freq=1, learning_rate=1e-3,
               lr_warmup_steps=2, use_pallas=False, seed=0,
               dataloader_num_workers=1, prefetch_batches=2)
UPDATES = ("zero1", "zero1,fsdp")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these tiny shapes: more only contend with
    the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _args(argv):
    args, device = cli.parse_cli(argv)
    args.decoder_only = "t5" not in args.model_name_or_path
    return args, device


# ---- what the ranks run ----------------------------------------------------

def _first_batch(args, mesh, batch_size):
    """The first shuffled training batch of this rank's data row."""
    train = cli.setup_data(args, cli.get_tokenizer(args.tokenizer_path))[0]
    loader = cli._loader(args, train, batch_size, mesh, shuffle=True,
                         seed=args.seed)
    loader.set_epoch(0)
    return next(iter(loader))


def _update(argv, mesh):
    """One update on ``mesh`` (Mesh() for one rank, on the global batch):
    (metrics, the model, its optimizer, its scheduler, its train step, the
    whole parameters before it)."""
    args, device = _args(argv)
    _, model, _, _ = cli._build(args, device, mesh)
    _seed_lora_b(model, mesh)
    before = _whole(model, mesh)
    opt, sched = cli.build_optimizer(args, model, mesh)
    step = cli.make_train_step(
        model, opt, sched, args.decoder_only, args.max_input_length,
        cli.get_tokenizer(args.tokenizer_path).pad_token_id,
        grad_accumulation_steps=args.grad_accumulation_steps,
        grad_clip=args.grad_clip, mesh=mesh)
    rows = args.per_device_train_batch_size * args.grad_accumulation_steps
    grads, take = {}, opt.step

    def whole_grads(*a, **kw):
        # the accumulated, synced and clipped gradients the update takes
        from mmgl_tpu_torch.parallel.mesh import full_tensor

        layout = getattr(model, "tp_layout", {})
        for name, p in model.named_parameters():
            if p.grad is not None:
                grads[name] = full_tensor(p.grad, layout.get(name),
                                          mesh).clone()
        opt.step = take
        return take(*a, **kw)

    opt.step = whole_grads
    metrics = step(_first_batch(args, mesh, rows))
    model.grads = grads
    return ({k: float(v) for k, v in metrics.items()}, model, opt, sched,
            step, before)


def _seed_lora_b(model, mesh):
    """LoRA's B (zero at init, so that A's gradient is 0) given seeded
    normal(0, 0.5) values, the rank's share of the same whole tensor on
    every mesh."""
    import zlib

    layout = getattr(model, "tp_layout", {})
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "lora_b" not in name:
                continue
            shape = list(p.shape)
            dim = layout.get(name)
            if dim is not None:
                shape[dim] *= mesh.n_model
            g = torch.Generator().manual_seed(zlib.crc32(name.encode()))
            whole = torch.randn(shape, generator=g) * 0.5
            if dim is not None:
                n = p.shape[dim]
                whole = whole.narrow(dim, mesh.model_index * n, n)
            p.copy_(whole)


def _whole(model, mesh):
    from mmgl_tpu_torch.train.checkpoints import _whole_params

    return {k: v.clone() for k, v in _whole_params(model, mesh).items()}


def task_update(mesh, out, argv, flags):
    """One update of ``argv`` with ``flags`` on the mesh and on one rank
    (the global batch of d x the per-rank batch): metrics of both, and
    each parameter's largest difference after it."""
    feats = [f for f in flags.split(",") if f]
    mesh_argv = argv + sum((["--" + f, "true"] for f in feats), [])
    got, model, *_ = _update(mesh_argv, mesh)
    one_argv = copy.copy(argv)
    i = one_argv.index("--per_device_train_batch_size")
    one_argv[i + 1] = str(int(argv[i + 1]) * mesh.n_data)
    want, ref, _, _, _, init = _update(one_argv, Mesh())
    whole, ref_params = _whole(model, mesh), _whole(ref, Mesh())
    return {"got": got, "want": want,
            "grads": {k: (float((model.grads[k] - g).abs().max()),
                          float(g.abs().max()))
                      for k, g in ref.grads.items()},
            "diffs": {k: float((whole[k] - v).abs().max())
                      for k, v in ref_params.items()},
            "moved": {k: float((init[k] - v).abs().max())
                      for k, v in ref_params.items()},
            "fsdp": bool(getattr(model, "fsdp", False)),
            "tp": len(getattr(model, "tp_layout", {}))}


def task_ce(mesh, out):
    """The vocab-parallel CE forms against the unsharded ones, and the
    vocab-parallel argmax, with every all-gather's size recorded."""
    from mmgl_tpu_torch.train import losses

    gathered = []
    all_gather = dist.all_gather

    def recording(parts, t, *a, **kw):
        gathered.append(t.numel())
        return all_gather(parts, t, *a, **kw)

    dist.all_gather = recording
    try:
        group, m, r = mesh.model_group, mesh.n_model, mesh.model_index
        g = torch.Generator().manual_seed(3)
        b, t, v, d = 2, 6, 520, 8
        logits = torch.randn(b, t, v, generator=g)
        labels = torch.randint(0, v, (b, t), generator=g)
        labels[0, :2] = -100
        cols = v // m
        shard = VocabShard(group, r * cols, v)
        res = {}
        for fused in (True, False):
            full = logits.clone().requires_grad_()
            want = losses.causal_losses(full, labels, 2, 0, fused_ce=fused)
            sum(want).backward()
            part = logits[..., r * cols:(r + 1) * cols].clone()
            part.requires_grad_()
            got = losses.causal_losses(part, labels, 2, 0, fused_ce=fused,
                                       vocab=shard)
            sum(got).backward()
            res["fused" if fused else "plain"] = {
                "value": max(abs(float((a - w).detach()))
                             for a, w in zip(got, want)),
                "grad": float((part.grad - full.grad[
                    ..., r * cols:(r + 1) * cols]).abs().max())}
        hidden = torch.randn(b, t, d, generator=g)
        emb = torch.randn(v, d, generator=g) * 0.3
        h1, e1 = hidden.clone().requires_grad_(), emb.clone().requires_grad_()
        want = losses.chunked_causal_losses(h1, e1, labels, 2, 0, n_chunks=3)
        sum(want).backward()
        h2 = hidden.clone().requires_grad_()
        e2 = emb[r * cols:(r + 1) * cols].clone().requires_grad_()
        got = losses.chunked_causal_losses(h2, e2, labels, 2, 0, n_chunks=3,
                                           vocab=shard)
        sum(got).backward()
        res["chunked"] = {
            "value": max(abs(float(a - w)) for a, w in zip(got, want)),
            "grad": max(float((h2.grad - h1.grad).abs().max()),
                        float((e2.grad - e1.grad[
                            r * cols:(r + 1) * cols]).abs().max()))}
        # argmax: the vocab's max, and a tie across the ranks' shards
        want_idx = torch.argmax(logits, dim=-1)
        part = logits[..., r * cols:(r + 1) * cols]
        got_idx = losses.vocab_argmax(part, shard)
        tied = torch.zeros(b, t, cols)
        tied[..., 3] = 1.0      # every shard's column 3: the lowest wins
        res["argmax"] = bool(torch.equal(got_idx, want_idx))
        res["tie"] = int(losses.vocab_argmax(tied, shard).unique().item())
        res["logits_numel_per_rank"] = b * t * cols
    finally:
        dist.all_gather = all_gather
    res["largest_gather"] = max(gathered)
    return res


def task_greedy(mesh, out):
    """Greedy tokens of the tensor-parallel model and of one rank."""
    from mmgl_tpu_torch.train.generate import greedy_generate

    args, device = _args(OPT_ARGV)
    batch = next(iter(cli.PrefetchLoader(
        cli.setup_data(args, cli.get_tokenizer(None))[2], batch_size=2,
        num_workers=1)))
    _, model, _, _ = cli._build(args, device, mesh)
    _, ref, _, _ = cli._build(args, device)
    return {"got": greedy_generate(model, batch, 8).tolist(),
            "want": greedy_generate(ref, batch, 8).tolist(),
            "heads": model.lm.local_heads, "ref_heads": ref.lm.local_heads}


def task_t5(mesh, out):
    """t5-tiny's eval step and one Adafactor update at (1, 2) against one
    rank: the relative-position bias is read at each rank's heads, its
    gradient summed over the model group."""
    res = task_update(mesh, out, T5_ARGV, "")
    args, device = _args(T5_ARGV)
    batch = _first_batch(args, Mesh(), 2)
    _, model, _, _ = cli._build(args, device, mesh)
    _, ref, _, _ = cli._build(args, device)
    pad = cli.get_tokenizer(None).pad_token_id
    got = cli.make_eval_step(model, False, 32, pad, mesh=mesh)(batch)
    want = cli.make_eval_step(ref, False, 32, pad)(batch)
    res["eval"] = {"loss": [float(got["loss"]), float(want["loss"])],
                   "predictions": bool(torch.equal(got["predictions"],
                                                   want["predictions"]))}
    res["bias_cut"] = [s.head_shard[1:] for s in (model.lm.encoder,
                                                  model.lm.decoder)]
    return res


def task_test_pass(mesh, out):
    """The test pass on the mesh: each eval sample scored once."""
    args, device = _args(OPT_ARGV + ["--test", "true",
                                     "--val_steps_per_epoch", "1"])
    return cli.run_test(args, device, None, mesh)


def task_checkpoint(mesh, out, flags):
    """One update on the mesh, saved (rank 0 writes the whole state); the
    whole parameters as the ranks see them; then the checkpoint restored
    onto a fresh mesh model and optimizer, whose shares and next update
    must equal the saving run's."""
    from mmgl_tpu_torch.train import checkpoints

    argv = OPT_ARGV + ["--" + flags, "true"]
    metrics, model, opt, sched, step, _ = _update(argv, mesh)
    path = os.path.join(out, f"ckpt_{flags}")
    checkpoints.save_checkpoint(path, model, opt, sched, 0, 0.0, 1, mesh)
    whole = _whole(model, mesh)
    if mesh.is_main:
        torch.save(whole, os.path.join(out, f"whole_{flags}.pt"))
    dist.barrier()
    args, device = _args(argv)
    _, fresh, _, _ = cli._build(args, device, mesh)
    fresh_opt, fresh_sched = cli.build_optimizer(args, fresh, mesh)
    checkpoints.restore_training_state(checkpoints.restore_checkpoint(path),
                                       fresh, fresh_opt, fresh_sched, mesh)
    same = all(torch.equal(a, b) for a, b in zip(
        _whole(fresh, mesh).values(), whole.values()))
    fresh_step = cli.make_train_step(
        fresh, fresh_opt, fresh_sched, True, args.max_input_length,
        cli.get_tokenizer(None).pad_token_id,
        grad_accumulation_steps=args.grad_accumulation_steps,
        grad_clip=args.grad_clip, mesh=mesh)
    batch = _first_batch(args, mesh, 4)
    again = {k: float(v) for k, v in step(batch).items()}
    restored = {k: float(v) for k, v in fresh_step(batch).items()}
    after = [float((a - b).abs().max()) for a, b in zip(
        _whole(fresh, mesh).values(), _whole(model, mesh).values())]
    # a checkpoint with a parameter the model lacks is refused on the mesh,
    # as on one device
    unknown = dict(checkpoints.restore_checkpoint(path)["params"],
                   **{"lm.not_a_parameter": torch.zeros(2)})
    try:
        checkpoints.merge_restored_params(fresh, unknown, mesh)
        refused = ""
    except KeyError as e:
        refused = str(e)
    return {"same_params": same, "again": again, "restored": restored,
            "after": max(after), "refused": refused}


def task_family5(mesh, out, port):
    """BASELINE family 5 through the entry point, ``--distributed`` over
    ``port`` at --mesh_shape 2,2, on the JAX package's initial weights
    (``jax_params.npz``); rank 0's logged training losses."""
    from mmgl_tpu_torch.utils.convert import state_dict_from_jax

    dist.destroy_process_group()
    flat = dict(np.load(os.path.join(out, "jax_params.npz")))
    tree = {}
    for key, value in flat.items():
        node = tree
        *parts, leaf = key.split("/")
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = value
    state = state_dict_from_jax(tree)
    build_model = cli.build_model

    def jax_weights(*a, **kw):
        model, cfg = build_model(*a, **kw)
        model.load_state_dict(state)
        return model, cfg

    argv = []
    for key, value in FAMILY5.items():
        argv += ["--" + key, str(value).lower() if isinstance(value, bool)
                 else str(value)]
    argv += ["--device", "cpu", "--log_dir", os.path.join(out, "family5"),
             "--mesh_shape", "2,2", "--distributed", "true",
             "--coordinator_address", f"127.0.0.1:{port}",
             "--num_processes", "4", "--process_id", str(mesh.rank)]
    logged = []
    cli.build_model = jax_weights
    try:
        args, device = cli.parse_cli(argv)
        results = cli.run(args, device,
                          lambda scalars, step: logged.append((step,
                                                               scalars)))
    finally:
        cli.build_model = build_model
    return {"train": [(step, s["train/loss"]) for step, s in logged
                      if "train/loss" in s], "results": results}


TASKS = {"update": task_update, "ce": task_ce, "greedy": task_greedy,
         "t5": task_t5, "test_pass": task_test_pass,
         "checkpoint": task_checkpoint, "family5": task_family5}


def _rank(rank, world, port, shape, out, plan):
    torch.set_num_threads(1)
    from mmgl_tpu_torch.parallel.mesh import init_distributed

    init_distributed(f"127.0.0.1:{port}", world, rank, "gloo")
    mesh = make_mesh(shape)
    for key, task, extra in plan:
        result = TASKS[task](mesh, out, *extra)
        torch.save(result, os.path.join(out, f"{key}.{rank}.pt"))
        if dist.is_initialized():
            dist.barrier()
    if dist.is_initialized():
        dist.destroy_process_group()


def _run_group(shape, out, plan):
    """Every check of ``plan`` ([(key, task, extra args)]) on one group of
    ranks at ``shape``; {key: [each rank's result]}."""
    world = shape[0] * shape[1]
    mp.spawn(_rank, args=(world, _free_port(), shape, str(out), plan),
             nprocs=world, join=True)
    got = {key: [torch.load(os.path.join(out, f"{key}.{r}.pt"),
                            weights_only=False) for r in range(world)]
           for key, _, _ in plan}
    got["_root"] = str(out)
    return got


def _updates(argv=OPT_ARGV):
    return [(f"update-{f}", "update", (argv, f)) for f in UPDATES]


@pytest.fixture(scope="module")
def group_1x2(tmp_path_factory):
    return _run_group((1, 2), tmp_path_factory.mktemp("mesh_1x2"),
                      _updates() + [("ce", "ce", ()),
                                    ("greedy", "greedy", ()),
                                    ("t5", "t5", ()),
                                    ("lora", "update", (LORA_ARGV, ""))])


@pytest.fixture(scope="module")
def jax_family5(tmp_path_factory):
    """The JAX package's run_training of family 5 on its 2 x 2 mesh (this
    process's host devices): its initial weights written for the ranks,
    and its logged training losses."""
    import jax

    from mmgl_tpu import cli as jcli
    from mmgl_tpu.config import Arguments

    out = tmp_path_factory.mktemp("mesh_2x2")
    captured, logged = {}, []
    maybe_import = jcli.maybe_import_pretrained

    def capture(params, args):
        # a host copy: the train step donates the device buffers
        params = maybe_import(params, args)
        captured["params"] = jax.tree_util.tree_map(
            lambda x: np.array(x, copy=True), params)
        return params

    jcli.maybe_import_pretrained = capture
    try:
        jcli.run_training(Arguments(log_dir=str(out / "jax"),
                                    mesh_shape=(2, 2), **FAMILY5),
                          lambda scalars, step: logged.append((step,
                                                               scalars)))
    finally:
        jcli.maybe_import_pretrained = maybe_import
    flat = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, prefix + (key,))
            else:
                flat["/".join(prefix + (key,))] = np.asarray(value)

    walk(captured["params"], ())
    np.savez(out / "jax_params.npz", **flat)
    return out, [(step, s["train/loss"]) for step, s in logged
                 if "train/loss" in s]


@pytest.fixture(scope="module")
def group_2x2(jax_family5):
    out, _ = jax_family5
    return _run_group((2, 2), out, _updates() + [
        ("test_pass", "test_pass", ()),
        ("checkpoint-zero1", "checkpoint", ("zero1",)),
        ("checkpoint-fsdp", "checkpoint", ("fsdp",)),
        ("family5", "family5", (_free_port(),))])


@pytest.fixture(scope="module")
def group_4x1(tmp_path_factory):
    return _run_group((4, 1), tmp_path_factory.mktemp("mesh_4x1"),
                      _updates())


# ---- the rule table ----------------------------------------------------------

RULE_CASES = {
    "family5": OPT_ARGV[:4] + ["--neighbor_mode", "embedding",
                               "--position_type", "laplacian",
                               "--peft_type", "prefix"] + TINY[2:],
    "lora": LORA_ARGV,
    "t5-prefix": ["--model_name_or_path", "t5-tiny", "--context",
                  "section_all", "--neighbor_mode", "embedding",
                  "--peft_type", "prefix"] + TINY,
    "mpt": ["--model_name_or_path", "mpt-tiny", "--context", "all",
            "--neighbor_mode", "embedding", "--peft_type", "flamingo"] + TINY,
}


def _jax_specs(argv, shape, fsdp):
    """{flax path: spec padded to the leaf's dims} from the JAX package's
    param_shardings over its model's eval_shape tree."""
    import jax

    from mmgl_tpu.models import factory as jfactory
    from mmgl_tpu.parallel import make_mesh as jax_mesh
    from mmgl_tpu.parallel import param_shardings
    from mmgl_tpu.utils.tokenizer import ByteTokenizer

    args, _ = _args(argv)
    jargs = copy.copy(args)
    jargs.use_pallas = False
    tok = ByteTokenizer()
    jmodel, _ = jfactory.build_model(jargs, vocab_size=tok.vocab_size,
                                     tokenizer=tok)
    batch = next(iter(cli.PrefetchLoader(
        cli.setup_data(args, cli.get_tokenizer(None))[0], batch_size=2,
        num_workers=1)))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch)
    shards = param_shardings(dict(shapes["params"]), jax_mesh(shape),
                             fsdp=fsdp)
    out = {}

    def walk(tree, leaves, prefix):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, leaves[key], prefix + (key,))
            else:
                ndim = len(leaves[key].shape)
                spec = tuple(value.spec)
                out["/".join(prefix + (key,))] = spec + (None,) * (
                    ndim - len(spec))

    walk(shards, shapes["params"], ())
    return args, out


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "tp+fsdp"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 2)], ids=["2x2", "4x2"])
def test_rule_table_gives_each_port_parameter_the_jax_spec(shape, fsdp):
    """For every parameter of BASELINE family 5, family 3 (LoRA), T5 with
    prefixes and MPT with flamingo, ``param_specs`` gives the spec that
    ``mmgl_tpu.parallel.param_shardings`` gives its flax path (exactly),
    and that path is a leaf of the JAX tree."""
    checked = 0
    for name, argv in RULE_CASES.items():
        args, want = _jax_specs(argv, shape, fsdp)
        _, model, _, _ = cli._build(args, torch.device("cpu"))
        mesh_shape = dict(zip(("data", "model"), shape))
        for pname, (path, spec, _) in param_specs(model, mesh_shape,
                                                  fsdp).items():
            assert path in want, (name, pname, path)
            ndim = len(want[path])
            assert spec + (None,) * (ndim - len(spec)) == want[path], (
                name, pname, path, spec, want[path])
            checked += 1
    assert checked > 300


# ---- one update on the mesh against one rank ---------------------------------

@pytest.mark.parametrize("flags", UPDATES)
@pytest.mark.parametrize("group", ["group_1x2", "group_2x2", "group_4x1"])
def test_opt_update_on_the_mesh_matches_one_rank(group, flags, request):
    """opt-tiny (raw, context all: CLIP tiny as its tower), one update of 2
    micro-batches with a clip that fires, AdamW, --zero1 (and --fsdp):
    every rank's loss, summary loss and gradient norm within rtol 1e-5 of
    one rank's on the global batch; each gradient the update takes (the
    shares gathered) within 1e-5 of its largest entry (plus 1e-9) of one
    rank's; and every parameter after the update within 1e-4 of one
    rank's, a tenth of the learning rate by which the update moves it
    (Adam's first step is g / (|g| + eps): where |g| is near eps, as for
    the key biases, whose true gradient is 0, the sums' order moves it by
    more than it moves g)."""
    results = request.getfixturevalue(group)[f"update-{flags}"]
    shape = {"group_1x2": (1, 2), "group_2x2": (2, 2),
             "group_4x1": (4, 1)}[group]
    for r in results:
        for key in ("loss", "summary_loss", "grad_norm"):
            np.testing.assert_allclose(r["got"][key], r["want"][key],
                                       rtol=1e-5, err_msg=key)
        assert len(r["grads"]) > 30
        for name, (err, top) in r["grads"].items():
            assert err <= 1e-5 * top + 1e-9, (name, err, top)
        assert max(r["diffs"].values()) <= 1e-4, max(
            r["diffs"].items(), key=lambda kv: kv[1])
        assert max(r["moved"].values()) > 1e-4      # the update moved them
        assert r["fsdp"] == ("fsdp" in flags and shape[0] > 1)
        assert (r["tp"] > 0) == (shape[1] > 1)


def test_lora_update_at_1x2_matches_one_rank(group_1x2):
    """BASELINE family 3's LoRA at (1, 2), B seeded non-zero (it starts at
    0, where A's gradient is 0): A's gradient is summed over the model
    group (its product with B's rank columns is a share), B's columns are
    the rank's; the same tolerances as the update above, A's gradient not
    0."""
    for r in group_1x2["lora"]:
        for key in ("loss", "summary_loss", "grad_norm"):
            np.testing.assert_allclose(r["got"][key], r["want"][key],
                                       rtol=1e-5, err_msg=key)
        lora = {k: v for k, v in r["grads"].items() if "lora_" in k}
        assert len(lora) == 8
        assert all(top > 0 for k, (_, top) in lora.items() if "lora_a" in k)
        for name, (err, top) in r["grads"].items():
            assert err <= 1e-5 * top + 1e-9, (name, err, top)
        assert max(r["diffs"].values()) <= 1e-4


# ---- the vocab-parallel CE and argmax, greedy decode -------------------------

@pytest.mark.parametrize("form", ["fused", "plain", "chunked"])
def test_vocab_parallel_ce_matches_the_unsharded_ce(group_1x2, form):
    """Each form over vocab-sharded logits (or the chunked CE's table
    rows) at (1, 2): the losses within 1e-6 and the gradient of each
    rank's columns (and of the hidden states) within 1e-6 of the unsharded
    CE's; no all-gather as large as a rank's logits."""
    for r in group_1x2["ce"]:
        assert r[form]["value"] <= 1e-6, r[form]
        assert r[form]["grad"] <= 1e-6, r[form]
        assert r["largest_gather"] < r["logits_numel_per_rank"]


def test_vocab_parallel_argmax_takes_the_lowest_index_of_a_tie(group_1x2):
    for r in group_1x2["ce"]:
        assert r["argmax"]
        assert r["tie"] == 3


def test_greedy_tokens_at_1x2_equal_one_rank(group_1x2):
    """opt-tiny's greedy decode at (1, 2), each rank at its half of the
    heads with a cache of them, emits one rank's tokens exactly."""
    for r in group_1x2["greedy"]:
        assert r["got"] == r["want"]
        assert r["heads"] * 2 == r["ref_heads"]


def test_t5_relative_bias_is_cut_at_each_ranks_heads(group_1x2):
    """t5-tiny at (1, 2): each rank reads its 2 of the 4 heads' columns of
    both bucket tables; the eval step's loss within rtol 1e-5 and its
    predictions exact; one Adafactor update's loss and norm within rtol
    1e-5, each gradient (the bucket tables', summed over the model group,
    among them) within 1e-5 of its largest entry of one rank's, and every
    parameter after it within 1e-4 (Adafactor's first step, like Adam's,
    is near g / |g|)."""
    for rank, r in enumerate(group_1x2["t5"]):
        assert r["bias_cut"] == [(2 * rank, 2)] * 2
        np.testing.assert_allclose(*r["eval"]["loss"], rtol=1e-5)
        assert r["eval"]["predictions"]
        for key in ("loss", "summary_loss", "grad_norm"):
            np.testing.assert_allclose(r["got"][key], r["want"][key],
                                       rtol=1e-5, err_msg=key)
        assert sum("relpos_bias" in k for k in r["grads"]) == 2
        for name, (err, top) in r["grads"].items():
            assert err <= 1e-5 * top + 1e-9, (name, err, top)
        assert max(r["diffs"].values()) <= 1e-4


# ---- the test pass, checkpoints, family 5 against the JAX package ------------

def test_test_pass_at_2x2_scores_each_sample_once(group_2x2):
    """The gather is over the data group only: d x the per-device batch of
    eval pairs (tests/test_multihost.py:98-104), and every rank the same
    metrics."""
    results = group_2x2["test_pass"]
    for r in results:
        assert r["n_eval_pairs"] == 2 * 2
        assert r == results[0]
        assert np.isfinite(r["loss"])


@pytest.mark.parametrize("flags", ["zero1", "fsdp"])
def test_checkpoint_at_2x2_restores_on_one_rank_and_back(group_2x2, flags):
    """A checkpoint saved at (2, 2) (ZeRO-1's state consolidated, or FSDP's
    shares gathered) holds the whole parameters in the one-device format:
    one rank restores them bit for bit and loads the optimizer state; a
    fresh (2, 2) model restores its shares bit for bit, and its next update
    equals the saving run's."""
    from mmgl_tpu_torch.train import checkpoints

    for r in group_2x2[f"checkpoint-{flags}"]:
        assert r["same_params"]
        assert r["restored"] == r["again"]
        assert r["after"] == 0.0
    root = group_2x2["_root"]
    ckpt = checkpoints.restore_checkpoint(os.path.join(root, f"ckpt_{flags}"))
    whole = torch.load(os.path.join(root, f"whole_{flags}.pt"))
    args, device = _args(OPT_ARGV)
    _, model, _, _ = cli._build(args, device)
    opt, sched = cli.build_optimizer(args, model)
    checkpoints.restore_training_state(ckpt, model, opt, sched)
    state = model.state_dict()
    assert sorted(whole) == sorted(ckpt["params"])
    for key, value in whole.items():
        assert torch.equal(state[key], value), key
    for p in (p for g in opt.param_groups for p in g["params"]):
        assert opt.state[p]["exp_avg"].shape == p.shape


@pytest.mark.parametrize("flags", ["zero1", "fsdp"])
def test_a_checkpoint_with_an_unknown_parameter_is_refused_at_2x2(
        group_2x2, flags):
    """merge_restored_params on the mesh raises for a checkpoint key the
    model lacks, naming it, on every rank, as it does on one device."""
    for r in group_2x2[f"checkpoint-{flags}"]:
        assert "unexpected ['lm.not_a_parameter']" in r["refused"]


def test_family5_at_2x2_matches_the_jax_mesh_run(group_2x2, jax_family5):
    """BASELINE family 5 (prefix tuning, Laplacian encodings, Roberta and
    CLIP towers) through the entry point on 4 ranks at --mesh_shape 2,2
    (--distributed over gloo), from the JAX package's initial weights: its
    two logged training losses within rtol 1e-5 of the JAX package's
    run_training on its 2 x 2 mesh; every rank the same test metrics."""
    _, want = jax_family5
    results = group_2x2["family5"]
    got = results[0]["train"]
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-5)
    for r in results:
        assert r["results"] == results[0]["results"]
        assert r["results"]["n_eval_pairs"] == 2 * 2


# ---- what the mesh refuses ---------------------------------------------------

def test_a_mesh_larger_than_the_world_raises_the_jax_error():
    """make_mesh raises the JAX package's ValueError (its message, for this
    world of one rank), and so does the entry point, in training and in the
    test pass, before anything is built."""
    from mmgl_tpu.parallel import make_mesh as jax_mesh

    with pytest.raises(ValueError) as jax_err:
        jax_mesh((4, 4))     # 16 of the 8 host devices
    with pytest.raises(ValueError) as err:
        make_mesh((2, 2))
    assert str(err.value) == "mesh (2, 2) needs 4 devices, have 1"
    assert str(jax_err.value) == "mesh (4, 4) needs 16 devices, have 8"


@pytest.mark.parametrize("test", ["false", "true"])
def test_the_entry_point_raises_for_a_mesh_larger_than_the_world(
        test, monkeypatch):
    built = []
    monkeypatch.setattr(cli, "build_model",
                        lambda *a, **kw: built.append(1))
    with pytest.raises(ValueError, match=r"mesh \(2, 2\) needs 4 devices"):
        cli.main(["--model_name_or_path", "opt-tiny", "--device", "cpu",
                  "--mesh_shape", "2,2", "--test", test])
    assert not built


def test_distributed_on_cuda_without_a_card_raises_before_joining(
        monkeypatch):
    """--distributed with --device cuda on a host without a GPU raises, as
    check_device does, and joins no process group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args, device = cli.parse_cli(["--device", "cuda", "--distributed",
                                  "true", "--num_processes", "2",
                                  "--process_id", "0",
                                  "--coordinator_address", "127.0.0.1:1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.setup_mesh(args, device)
    assert not dist.is_initialized()
