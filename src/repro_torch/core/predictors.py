"""The predictor ladder (paper Sec 3.2 / Appendix B): the port of the JAX
package's ``core/predictors.py``.

Distribution-Only:
  * ``DistributionEstimator`` — multinomial MLE with a moving average over
    batches (Eq. 1 / Appendix A). Zero inference-time cost: its input is
    the expert histogram the router produces anyway.

Token-to-Expert (increasing accuracy and overhead):
  * ``ProbabilityModel``            — global most-frequent expert per layer.
  * ``ConditionalProbabilityModel`` — most-frequent expert per token id (or
    per position) per layer.
  * ``FFNPredictor``   — embed -> 128 MLP -> ReLU -> 128 -> per-layer heads.
  * ``LSTMPredictor``  — embed -> 128 -> 2-layer LSTM(64) -> windowed
    ("sparse") attention -> residual MLP -> per-layer heads.

The frequency models are numpy, as in the JAX package. The neural ones are
``nn.Module``s on an explicit ``device`` (default ``"cuda"``), initialised
from a ``torch.Generator`` seeded with ``seed``; their parameters are a
tree (nested dict) of fp32 tensors, ``params``, and ``apply(params,
tokens)`` is the forward as a function of that tree (so ``_fit_neural``
differentiates it with ``torch.autograd`` and steps it with
``optim.adamw_update``, as the JAX package does with ``jax.grad`` and its
AdamW). The LSTM runs the reference's recurrence step by step: gates in
the order i, f, g, o, one bias, zero fp32 initial state.

Every predictor exposes ``flops_per_token(num_layers)`` (the JAX values)
so the simulator can convert accuracy into runtime overhead; ``predict``
returns (L, N, S) int32 labels, ties going to the lowest expert index.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.layers import truncated_normal_init
from repro_torch.optim.adamw import (adamw_init, adamw_update, tree_leaves,
                                     tree_map)


# ---------------------------------------------------------------------------
# Distribution-Only (multinomial MLE with moving average)
# ---------------------------------------------------------------------------

class DistributionEstimator:
    """EMA multinomial MLE over per-layer expert histograms."""

    def __init__(self, num_layers: int, num_experts: int, ema: float = 0.9):
        self.counts = np.zeros((num_layers, num_experts), np.float64)
        self.ema = ema
        self._initialized = False

    def update(self, batch_counts: np.ndarray):
        """batch_counts: (L, E) token counts from one batch."""
        bc = np.asarray(batch_counts, np.float64)
        if not self._initialized:
            self.counts = bc.copy()
            self._initialized = True
        else:
            self.counts = self.ema * self.counts + (1 - self.ema) * bc

    def predict(self) -> np.ndarray:
        tot = np.maximum(self.counts.sum(axis=1, keepdims=True), 1e-9)
        return self.counts / tot

    @staticmethod
    def flops_per_token(num_layers: int) -> float:
        return 0.0      # estimation is offline / a histogram side-effect


# ---------------------------------------------------------------------------
# Frequency models
# ---------------------------------------------------------------------------

class ProbabilityModel:
    """argmax of the global expert frequency per layer (Appendix B Eq. 7-8)."""

    def __init__(self, num_layers: int, num_experts: int):
        self.counts = np.zeros((num_layers, num_experts), np.int64)

    def fit(self, experts: np.ndarray, tokens=None):
        """experts: (L, N, S) top-1 expert labels."""
        L, E = self.counts.shape
        for l in range(L):
            self.counts[l] += np.bincount(experts[l].reshape(-1), minlength=E)
        return self

    def predict(self, tokens: np.ndarray) -> np.ndarray:
        """tokens: (N, S) -> (L, N, S) predicted experts."""
        top = self.counts.argmax(axis=1)                       # (L,)
        L = top.shape[0]
        return np.broadcast_to(top[:, None, None],
                               (L,) + tokens.shape).astype(np.int32)

    @staticmethod
    def flops_per_token(num_layers: int) -> float:
        return 1.0      # a lookup


class ConditionalProbabilityModel:
    """argmax expert conditioned on token id or position (Appendix B Eq. 9-10)."""

    def __init__(self, num_layers: int, num_experts: int, vocab: int,
                 condition: str = "token"):
        self.condition = condition
        self.vocab = vocab
        self.num_experts = num_experts
        self.num_layers = num_layers
        self.table = None          # (L, vocab_or_positions) best expert

    def fit(self, experts: np.ndarray, tokens: np.ndarray):
        L, N, S = experts.shape
        E = self.num_experts
        if self.condition == "token":
            dim = self.vocab
            idx = np.broadcast_to(tokens[None], (L, N, S))
        else:
            dim = S
            idx = np.broadcast_to(np.arange(S)[None, None, :], (L, N, S))
        table = np.zeros((L, dim), np.int32)
        for l in range(L):
            cnt = np.zeros((dim, E), np.int64)
            np.add.at(cnt, (idx[l].reshape(-1), experts[l].reshape(-1)), 1)
            table[l] = cnt.argmax(axis=1)
        self.table = table
        return self

    def predict(self, tokens: np.ndarray) -> np.ndarray:
        N, S = tokens.shape
        L = self.num_layers
        if self.condition == "token":
            return np.stack([self.table[l][tokens] for l in range(L)])
        return np.broadcast_to(self.table[:, None, :S],
                               (L, N, S)).astype(np.int32)

    @staticmethod
    def flops_per_token(num_layers: int) -> float:
        return float(num_layers)   # one lookup per layer


# ---------------------------------------------------------------------------
# Neural predictors
# ---------------------------------------------------------------------------

HID = 128
LSTM_HID = 64


def _init_heads(generator, num_layers, hid, num_experts, device):
    return truncated_normal_init((num_layers, hid, num_experts),
                                 1 / math.sqrt(hid), generator=generator,
                                 device=device)


def _paths(tree, prefix=()):
    """[(key path, leaf)] of a tree in sorted-key order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _paths(tree[k],
                                                          prefix + (k,))]
    return [(prefix, tree)]


class _NeuralPredictor(nn.Module):
    """Shared plumbing: every leaf of the parameter tree is a registered
    ``nn.Parameter`` (named by its key path joined with ``_``); ``params``
    reads them back as the tree and assigning a tree writes them."""

    def __init__(self, num_layers: int, num_experts: int, seed: int, device):
        super().__init__()
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._keys = []

    def _init(self, shape, scale):
        return truncated_normal_init(shape, scale, generator=self._gen,
                                     device=self.device)

    def _register_tree(self, tree: Dict) -> None:
        for path, leaf in _paths(tree):
            name = "_".join(path)
            self.register_parameter(name, nn.Parameter(leaf,
                                                       requires_grad=False))
            self._keys.append((path, name))

    @property
    def params(self) -> Dict:
        tree: Dict = {}
        for path, name in self._keys:
            sub = tree
            for k in path[:-1]:
                sub = sub.setdefault(k, {})
            sub[path[-1]] = getattr(self, name)
        return tree

    @params.setter
    def params(self, tree: Dict) -> None:
        leaves = dict(_paths(tree))
        for path, name in self._keys:
            getattr(self, name).data = leaves[path].detach().to(
                device=self.device, dtype=torch.float32)

    def forward(self, tokens):
        return self.apply(self.params, tokens)

    def fit(self, experts: np.ndarray, tokens: np.ndarray, *, steps=300,
            batch=64, lr=3e-3, seed=0):
        return _fit_neural(self, experts, tokens, steps=steps, batch=batch,
                           lr=lr, seed=seed)

    @torch.inference_mode()
    def predict(self, tokens: np.ndarray) -> np.ndarray:
        """tokens: (N, S) -> (L, N, S) int32 argmax labels."""
        t = torch.as_tensor(np.asarray(tokens), device=self.device)
        logits = self.apply(self.params, t)
        return logits.argmax(-1).to(torch.int32).cpu().numpy()


class FFNPredictor(_NeuralPredictor):
    """Two-layer MLP over token embeddings with per-MoE-layer heads."""

    def __init__(self, num_layers: int, num_experts: int, vocab: int, seed=0,
                 device="cuda"):
        super().__init__(num_layers, num_experts, seed, device)
        self._register_tree({
            "embed": self._init((vocab, HID), 0.02),
            "w1": self._init((HID, HID), 1 / math.sqrt(HID)),
            "w2": self._init((HID, HID), 1 / math.sqrt(HID)),
            "heads": _init_heads(self._gen, num_layers, HID, num_experts,
                                 self.device),
        })

    def apply(self, params, tokens):
        """tokens: (B, S) -> logits (L, B, S, E)."""
        x = params["embed"][tokens.long()]
        h = torch.relu(x @ params["w1"])
        h = h @ params["w2"]
        return torch.einsum("bsh,lhe->lbse", h, params["heads"])

    def flops_per_token(self, num_layers: int) -> float:
        return 2 * HID * HID * 2 + 2 * HID * self.num_experts * num_layers


class LSTMPredictor(_NeuralPredictor):
    """2-layer LSTM(64) with windowed attention + residual MLP (Appendix B)."""

    WINDOW = 16     # "sparse attention" = local window over LSTM outputs

    def __init__(self, num_layers: int, num_experts: int, vocab: int, seed=0,
                 device="cuda"):
        super().__init__(num_layers, num_experts, seed, device)
        H = LSTM_HID

        def lstm_params(d_in):
            return {"wx": self._init((d_in, 4 * H), 1 / math.sqrt(d_in)),
                    "wh": self._init((H, 4 * H), 1 / math.sqrt(H)),
                    "b": torch.zeros((4 * H,), device=self.device)}
        self._register_tree({
            "embed": self._init((vocab, HID), 0.02),
            "compress": self._init((HID, HID), 1 / math.sqrt(HID)),
            "lstm1": lstm_params(HID),
            "lstm2": lstm_params(H),
            "attn_scale": torch.ones((), device=self.device),
            "res_mlp": self._init((HID, H), 1 / math.sqrt(HID)),
            "heads": _init_heads(self._gen, num_layers, H, num_experts,
                                 self.device),
        })

    def fit(self, experts, tokens, *, steps=300, batch=32, lr=3e-3, seed=0):
        return _fit_neural(self, experts, tokens, steps=steps, batch=batch,
                           lr=lr, seed=seed)

    @staticmethod
    def _lstm(p, xs):
        """xs: (B, S, d_in) -> hidden states (B, S, H), one step at a time.
        The input products of all steps are taken at once; each step adds
        its recurrent product and then the bias, the reference's order."""
        H = LSTM_HID
        B, S, _ = xs.shape
        xw = xs @ p["wx"]                                    # (B, S, 4H)
        h = torch.zeros((B, H), dtype=torch.float32, device=xs.device)
        c = torch.zeros((B, H), dtype=torch.float32, device=xs.device)
        hs = []
        for t in range(S):
            z = xw[:, t] + h @ p["wh"] + p["b"]
            sg = torch.sigmoid(z)
            i, f, o = sg[:, :H], sg[:, H:2 * H], sg[:, 3 * H:]
            g = torch.tanh(z[:, 2 * H:3 * H])
            c = f * c + i * g
            h = o * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs, dim=1)

    def apply(self, params, tokens):
        """tokens: (B, S) -> logits (L, B, S, E)."""
        x = params["embed"][tokens.long()]                   # (B, S, HID)
        x = torch.relu(x @ params["compress"])
        h = self._lstm(params["lstm1"], x)
        h = self._lstm(params["lstm2"], h)
        # windowed self-attention over LSTM outputs (q = k = v = h)
        B, S, H = h.shape
        W = min(self.WINDOW, S)
        scores = torch.einsum("bsh,bth->bst", h, h) * params["attn_scale"] \
            / math.sqrt(H)
        pos = torch.arange(S, device=h.device)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
        scores = torch.where(mask[None], scores,
                             torch.tensor(-1e30, device=h.device))
        attn = torch.softmax(scores, dim=-1) @ h
        out = attn + x @ params["res_mlp"]                   # residual feedforward
        return torch.einsum("bsh,lhe->lbse", out, params["heads"])

    def flops_per_token(self, num_layers: int) -> float:
        H = LSTM_HID
        lstm = 2 * (HID * 4 * H + H * 4 * H) + 2 * (H * 4 * H + H * 4 * H)
        attnf = 2 * 2 * self.WINDOW * H
        return (2 * HID * HID + lstm + attnf + 2 * HID * H
                + 2 * H * self.num_experts * num_layers)


def _fit_neural(model: _NeuralPredictor, experts: np.ndarray,
                tokens: np.ndarray, *, steps, batch, lr, seed):
    """Cross-entropy training over (tokens -> per-layer expert labels): the
    reference's batches (``np.random.default_rng(seed)``), loss and AdamW
    (without weight decay), gradients from ``torch.autograd``."""
    rng = np.random.default_rng(seed)
    N = tokens.shape[0]
    dev = model.device
    params = tree_map(lambda p: p.detach().clone(), model.params)
    opt = adamw_init(params)

    def loss_fn(p, tok, lab):
        logits = model.apply(p, tok)                        # (L, B, S, E)
        logp = F.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
        return nll.mean()

    for _ in range(steps):
        idx = rng.choice(N, size=min(batch, N), replace=False)
        tok = torch.as_tensor(tokens[idx], device=dev)
        lab = torch.as_tensor(experts[:, idx], device=dev).long()
        leaves = [leaf.requires_grad_(True) for leaf in tree_leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(params, tok, lab)
            grads_flat = torch.autograd.grad(loss, leaves)
        grads = _unflatten(params, grads_flat)
        params = tree_map(lambda p: p.detach(), params)
        params, opt, _ = adamw_update(params, grads, opt, lr,
                                      weight_decay=0.0)
    model.params = params
    return model


def _unflatten(like: Dict, flat):
    """The leaves ``flat`` (in ``tree_leaves`` order) as a tree shaped like
    ``like``."""
    it = iter(flat)
    return tree_map(lambda _: next(it), like)


def accuracy(pred: np.ndarray, truth: np.ndarray) -> float:
    """pred/truth: (L, N, S) -> mean token-level top-1 accuracy."""
    return float((pred == truth).mean())
