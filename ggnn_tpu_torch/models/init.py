"""Parameter initialization and conversion to and from numpy.

The nested-dict layout and shapes are those of ``ggnn_tpu/models/init.py``
(and of the NumPy oracle): ``{"prop": {"msg_w", "msg_b", "gru": {...}},
"head": {...}}`` and so on.  Every weight and bias is drawn from
U(−1/√fan_in, 1/√fan_in).  The numbers differ from the JAX package's for
the same seed (different generators); a model moves between the packages
through :func:`params_from_numpy` / :func:`params_to_numpy` or a checkpoint.
"""

from __future__ import annotations

import numpy as np
import torch

from ggnn_tpu_torch.models.config import ModelConfig


def device_or_raise(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises
    (the entry points default to the card and never fall back to the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but no CUDA "
                           "device is available (torch.cuda.is_available() "
                           "is false); pass device='cpu' to run on the CPU")
    return device


def torch_dtype(name) -> torch.dtype:
    """torch dtype for a config dtype name ('float32', 'bfloat16', ...)."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class _Init:
    def __init__(self, generator, device, dtype):
        self.gen, self.device, self.dtype = generator, device, dtype

    def uniform(self, shape, fan_in):
        bound = 1.0 / (fan_in ** 0.5)
        x = torch.empty(shape, dtype=torch.float32)
        x.uniform_(-bound, bound, generator=self.gen)
        return x.to(device=self.device, dtype=self.dtype)

    def linear(self, d_in, d_out):
        return self.uniform((d_in, d_out), d_in), self.uniform((d_out,), d_in)


def _prop(ini: _Init, cfg: ModelConfig) -> dict:
    D, T2 = cfg.state_dim, cfg.n_message_types
    prop = {"msg_w": ini.uniform((T2, D, D), D),
            "msg_b": ini.uniform((T2, D), D)}
    gru = {}
    for g in ("z", "r", "h"):
        gru[f"w{g}"] = ini.uniform((D, D), D)
        gru[f"u{g}"] = ini.uniform((D, D), D)
        gru[f"b{g}"] = ini.uniform((D,), D)
    prop["gru"] = gru
    if cfg.edge_gates:
        G = cfg.gate_dim or D
        prop["gate_p"] = ini.uniform((D, G), D)
        prop["gate_q"] = ini.uniform((D, G), D)
    return prop


def _mlp_head(ini: _Init, cfg: ModelConfig, n_out: int) -> dict:
    d_in = cfg.state_dim + cfg.annotation_dim
    w1, b1 = ini.linear(d_in, cfg.head_hidden)
    w2, b2 = ini.linear(cfg.head_hidden, n_out)
    return {"w1": w1, "b1": b1, "w2": w2, "b2": b2}


def _gated_head(ini: _Init, cfg: ModelConfig, n_out: int) -> dict:
    d_in = cfg.state_dim + cfg.annotation_dim
    G = cfg.readout_dim
    gi_w, gi_b = ini.linear(d_in, G)
    gj_w, gj_b = ini.linear(d_in, G)
    c1, c1b = ini.linear(G, G)
    c2, c2b = ini.linear(G, n_out)
    return {"gi_w": gi_w, "gi_b": gi_b, "gj_w": gj_w, "gj_b": gj_b,
            "c1": c1, "c1b": c1b, "c2": c2, "c2b": c2b}


def _annotation_net(ini: _Init, cfg: ModelConfig) -> dict:
    d_in = cfg.state_dim + cfg.annotation_dim
    a1, a1b = ini.linear(d_in, cfg.head_hidden)
    a2, a2b = ini.linear(cfg.head_hidden, cfg.annotation_dim)
    return {"a1": a1, "a1b": a1b, "a2": a2, "a2b": a2b}


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cpu") -> dict:
    """Full parameter tree for the configured head (oracle layout)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    ini = _Init(generator, torch.device(device), torch_dtype(cfg.param_dtype))
    params = {"prop": _prop(ini, cfg)}
    if cfg.head == "node_select":
        params["head"] = _mlp_head(ini, cfg, 1)
    elif cfg.head == "per_node":
        params["head"] = _mlp_head(ini, cfg, cfg.n_classes)
    elif cfg.head == "graph_gated":
        params["head"] = _gated_head(ini, cfg, cfg.n_classes)
    elif cfg.head == "ggsnn":
        def out_head():
            if cfg.ggsnn_output == "node":
                return _mlp_head(ini, cfg, 1)
            return _gated_head(ini, cfg, cfg.n_classes)
        if cfg.share_round_nets:
            params["out"] = out_head()
            params["ann"] = _annotation_net(ini, cfg)
        else:
            outs = [out_head() for _ in range(cfg.n_rounds)]
            anns = [_annotation_net(ini, cfg) for _ in range(cfg.n_rounds)]
            params["out"] = {k: torch.stack([o[k] for o in outs])
                             for k in outs[0]}
            params["ann"] = {k: torch.stack([a[k] for a in anns])
                             for k in anns[0]}
    else:
        raise ValueError(f"unknown head {cfg.head!r}")
    return params


def params_from_numpy(tree, device="cpu"):
    """Nested dicts/lists of arrays (e.g. the JAX package's parameters after
    ``np.asarray``) → the same tree of tensors on ``device``.  Tensors in
    the tree are moved as they are."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    if torch.is_tensor(tree):
        return tree.to(device)
    return torch.as_tensor(np.array(tree), device=device)


def params_to_numpy(tree):
    """Tree of tensors → the same tree of numpy arrays (on the host)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        raise ValueError("bfloat16 parameters have no numpy dtype; cast to "
                         "float32 first")
    return t.numpy()
