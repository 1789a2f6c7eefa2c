"""Legs of ``tests/test_torch_dist_tp.py`` and
``tests/test_torch_dist_tp_train.py``: the port's engines and train step
with one rank a process (``launch.mesh``) under a parameter layout
(``sharding``: "specs", "fsdp"). The module imports torch and
``repro_torch`` only, so the ranks that ``launch.mesh.spawn`` starts import
it quickly; ``run_serve_rank`` and ``run_train_rank`` are their entry
points and return numpy arrays.

Every leg builds its model from the JAX init's tree the test passes
(``params_from_jax(..., shard=bridge.sharder(cfg, mesh, layout))``: this
rank's block of every leaf). Serving legs run ``ServeEngine.generate`` on
``BATCHES`` seeded batches (``serve_tp``, shared with the JAX subprocess,
which ``exec``s ``CAPTURE``) and record each batch's tokens and every
prefill's and decode step's logits. Training legs take ``STEPS`` AdamW
steps at ``LR`` and record each step's metrics and first moments, the
parameters after the last step (the blocks gathered whole,
``sharding.gather_whole``), and the bytes of the parameters and moments
this process holds beside the sum of its ``shard_tensor`` blocks.
"""

import inspect
import math
import types

import numpy as np
import torch

from repro_torch.bridge import checkpoint_tree, params_from_jax, sharder
from repro_torch.configs.registry import get_config
from repro_torch.models.transformer import Runtime
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.sharding import gather_whole, placement
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.steps import init_opt_state, make_train_step

SERVE_ARCHS = ("stablelm-3b", "mixtral-8x7b", "recurrentgemma-2b",
               "rwkv6-7b", "deepseek-v2-lite-16b", "seamless-m4t-medium",
               "llava-next-34b")
SERVE_MESHES = ((1, 4), (2, 2))
BATCHES, B, S, NEW, FRAMES = 2, 4, 16, 5, 12
STEP_S = 3e-5                 # the pinned overlap window (MoE store fills)
# a MoE model's engine: Distribution-Only with the replica store, as
# tests/_torch_dist_serve.py serves it; the others have no strategy
MOE_SERVE_KW = dict(strategy="dist_only", predict_interval=1, dup_slots=1,
                    max_len=S + NEW + 8, migrate_chunk=2)
DENSE_SERVE_KW = dict(strategy="none", max_len=S + NEW + 8)

# training: mesh -> (layout, archs)
TRAIN = {(1, 4): ("specs", ("qwen1.5-0.5b", "mixtral-8x7b",
                            "recurrentgemma-2b", "rwkv6-7b")),
         (2, 2): ("fsdp", ("qwen1.5-0.5b", "mixtral-8x7b",
                           "deepseek-v2-lite-16b", "seamless-m4t-medium"))}
TB, TS, LR, STEPS = 4, 32, 1e-3, 2


def gathered_leaves(cfg, model_axis: int):
    """The layer leaves (port names without ``layers.{l}.``; an encoder
    layer's as ``enc.`` + name) that the "specs" layout stores split over
    a "model" axis of ``model_axis`` ranks and gathers at use: head
    projections whose blocks split a head (``sharding.leaf_use``)."""
    mesh = types.SimpleNamespace(shape={"data": 1, "model": model_axis},
                                 model=model_axis, data_index=0,
                                 model_index=0)
    shard = sharder(cfg, mesh, "specs")
    return sorted({("enc." if n.startswith("enc_") else "")
                   + n.split(".", 2)[2]
                   for n, use in shard.uses.items() if use == "gathered"})


def widen_head(tree, cfg, groups: int = 8):
    """The ``lm_head`` half of ``tests/_torch_margins.py``'s
    ``widen_margins`` for any family: every token of group g = t * G // V
    gets a large component along a unit vector v_g (the v_g orthonormal),
    so the rmsnorm'ed hidden states point along v_g, and ``lm_head``
    prefers the next group's token 7 by about 12 logits over the random
    rest. Arrays in the JAX tree's layout."""
    d, V = cfg.d_model, cfg.vocab_size
    v = np.linalg.qr(np.random.default_rng(1234).normal(
        size=(d, groups)))[0].T
    group = np.arange(V) * groups // V
    nxt = (np.arange(groups) + 1) % groups * (V // groups) + 7
    out = dict(tree)
    out["embed"] = {"table": np.asarray(tree["embed"]["table"], np.float32)
                    + 8.0 * np.sqrt(d) * v[group]}
    head = np.array(tree["lm_head"]["w"], np.float32)
    head[:, nxt] += v.T
    out["lm_head"] = {"w": head}
    return out


WIDEN_SOURCE = inspect.getsource(widen_head)


def serve_batches(cfg):
    """BATCHES seeded batches of B x S tokens (numpy), with frames for an
    encoder-decoder and prefix embeddings for a VLM."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(BATCHES):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)}
        if cfg.is_encdec:
            b["frames"] = rng.normal(size=(B, FRAMES, cfg.encoder.d_model)
                                     ).astype(np.float32)
        if cfg.input_mode == "mixed":
            b["prefix_embeds"] = rng.normal(
                size=(B, cfg.num_prefix_embeddings, cfg.d_model)).astype(
                    np.float32)
        out.append(b)
    return out


CAPTURE = '''
def serve_tp(eng, batches, new_tokens, step_s, to_np):
    eng._note_step_time = lambda dt: None
    rec = {"tokens": [], "prefill": [], "decode": []}
    prefill, decode = eng.prefill, eng.decode

    def pinned_prefill(*a, **k):
        eng._recent_step_s = step_s
        out = prefill(*a, **k)
        rec["prefill"].append(to_np(out[0]))
        return out

    def pinned_decode(*a, **k):
        eng._recent_step_s = step_s
        out = decode(*a, **k)
        rec["decode"].append(to_np(out[1]))
        return out
    eng.prefill, eng.decode = pinned_prefill, pinned_decode
    for b in batches:
        out, _ = eng.generate(b, max_new_tokens=new_tokens)
        rec["tokens"].append(np.asarray(out).tolist())
    return rec
'''

_SCOPE = {"np": np}
exec(CAPTURE, _SCOPE)


def _to_np(t):
    return t.float().cpu().numpy()


def held_bytes(model, shard) -> dict:
    """The parameter bytes this process holds, and the sum over its
    leaves of the bytes of ``Sharder.block_shape`` (``shard_tensor``'s
    block) in the parameter's dtype: what the layout says it holds."""
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    want = sum(math.prod(shard.block_shape(name)) * p.element_size()
               for name, p in model.named_parameters())
    return {"held": held, "blocks": want}


def serve_leg(arch, tree, mesh, layout="specs"):
    """``arch``'s engine over ``mesh`` on the tree's weights (bf16 serving
    storage), every batch of ``serve_batches``."""
    cfg = get_config(arch).reduced()
    shard = sharder(cfg, mesh, layout)
    model = params_from_jax(tree, cfg, device="cpu", shard=shard)
    kw = MOE_SERVE_KW if cfg.is_moe else DENSE_SERVE_KW
    eng = ServeEngine(cfg, model, ServeConfig(**kw), ep=cfg.is_moe,
                      ep_ranks=mesh.model if cfg.is_moe else 1, mesh=mesh)
    rec = _SCOPE["serve_tp"](eng, serve_batches(cfg), NEW, STEP_S, _to_np)
    rec["bytes"] = held_bytes(model, shard)
    rec["uses"] = {n: placement(p).use for n, p in model.named_parameters()}
    return rec


def run_serve_rank(mesh, trees: dict, archs):
    """The entry point of each spawned serving rank."""
    return {a: serve_leg(a, trees[a], mesh) for a in archs}


def train_batch(cfg) -> dict:
    """The seeded batch of TB x TS tokens, labels, and frames or prefix
    embeddings where the family takes them."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (TB, TS + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encdec:
        batch["frames"] = rng.normal(
            size=(TB, FRAMES, cfg.encoder.d_model)).astype(np.float32)
    if cfg.input_mode == "mixed":
        batch["prefix_embeds"] = rng.normal(
            size=(TB, cfg.num_prefix_embeddings, cfg.d_model)).astype(
                np.float32)
    return batch


def _whole(t, rec):
    """The whole leaf of block ``t`` as a numpy copy (AdamW updates the
    moments in place)."""
    return np.array(gather_whole(t, rec).float().cpu().numpy())


def train_leg(arch, tree, mesh, layout, ckpt_path=""):
    """``STEPS`` train steps of ``arch`` over ``mesh`` under ``layout``
    (fp32 trainable weights from the tree; EP over the model axis for a MoE
    model, as the JAX launcher runs it): each step's metrics and first
    moments (after the first step, the clipped gradients times 1 - b1),
    the parameters after the last."""
    cfg = get_config(arch).reduced()
    shard = sharder(cfg, mesh, layout)
    model = params_from_jax(tree, cfg, device="cpu", trainable=True,
                            shard=shard)
    recs = {n: placement(p) for n, p in model.named_parameters()}
    step = make_train_step(cfg, Runtime(ep=cfg.is_moe, ep_ranks=mesh.model,
                                        mesh=mesh), lr_fn=lambda s: LR)
    opt = init_opt_state(model)
    batch = train_batch(cfg)
    out = {"metrics": [], "mu": []}
    for _ in range(STEPS):
        opt, m = step(model, opt, batch)
        out["metrics"].append({k: np.asarray(torch.as_tensor(v).detach()
                                             .float()) for k, v in m.items()})
        out["mu"].append({n: _whole(opt.mu[n], recs[n]) for n in opt.mu})
    out["params"] = {n: _whole(p.data, recs[n])
                     for n, p in model.named_parameters()}
    out["bytes"] = held_bytes(model, shard)
    out["moment_bytes"] = {"held": sum(t.numel() * t.element_size()
                                       for t in opt.mu.values()),
                           "blocks": out["bytes"]["blocks"]}
    out["uses"] = {n: r.use for n, r in recs.items()}
    out["data_dims"] = {n: r.data_dim for n, r in recs.items()}
    if ckpt_path:
        tree_out = checkpoint_tree(model, opt, mesh)
        if mesh.rank == 0:
            ckpt.save(ckpt_path, tree_out)
    return out


def run_train_rank(mesh, trees: dict, layout: str, archs, ckpt_path=""):
    """The entry point of each spawned training rank."""
    torch.manual_seed(0)
    return {a: train_leg(a, trees[a], mesh, layout,
                         ckpt_path if a == archs[0] else "")
            for a in archs}

