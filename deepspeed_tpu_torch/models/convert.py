"""Parameters from the JAX package's pytree.

The one place the two packages' parameter layouts meet. The caller turns
the JAX tree into nested dicts of numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``); the port never sees JAX.
The port keeps the JAX layout (stacked layers, ``[in, out]`` kernels,
``wte``/``wpe``/``ln_f``/``lm_head`` at the top), so conversion is a
checked copy onto the device in the working dtype. A BERT tree
(``models.bert``: embeddings, the stacked encoder ``block``, pooler, MLM
and NSP heads, and the SQuAD ``qa`` head where present) is checked against
a ``BertConfig``. A tree the JAX
package has already quantized (``quantize_weights_int8``: a dense entry
holds ``{"q": int8, "scale": fp32}`` in place of ``{"kernel"}``) keeps its
int8 codes and its fp32 scales.
"""

from typing import Dict, Union

import numpy as np
import torch

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.models.bert import BertConfig
from deepspeed_tpu_torch.models.gpt import GPTConfig


def _bert_shapes(cfg: BertConfig, with_qa: bool) -> Dict[str, tuple]:
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    ff = cfg.layer_config.intermediate_size
    shapes = {
        "embeddings/word": (V, d),
        "embeddings/position": (cfg.max_seq_len, d),
        "embeddings/token_type": (cfg.type_vocab_size, d),
        "pooler/kernel": (d, d), "pooler/bias": (d,),
        "mlm/kernel": (d, d), "mlm/bias": (d,), "mlm/decoder_bias": (V,),
        "nsp/kernel": (d, 2), "nsp/bias": (2,),
    }
    for ln in ("embeddings/ln", "mlm/ln"):
        shapes.update({f"{ln}/scale": (d,), f"{ln}/bias": (d,)})
    for name, n_in, n_out in (("qkv", d, 3 * d), ("attn_out", d, d),
                              ("mlp_in", d, ff), ("mlp_out", ff, d)):
        shapes[f"block/{name}/kernel"] = (L, n_in, n_out)
        shapes[f"block/{name}/bias"] = (L, n_out)
    for ln in ("ln1", "ln2"):
        shapes.update({f"block/{ln}/scale": (L, d),
                       f"block/{ln}/bias": (L, d)})
    if with_qa:
        shapes.update({"qa/kernel": (d, 2), "qa/bias": (2,)})
    return shapes


def _expected_shapes(cfg: GPTConfig) -> Dict[str, tuple]:
    d, L, ff, V = cfg.d_model, cfg.n_layers, cfg.ffn_dim, cfg.vocab_size
    shapes = {
        "wte/embedding": (V, d),
        "block/qkv/kernel": (L, d, cfg.qkv_dim),
        "block/attn_out/kernel": (L, d, d),
        "block/mlp_in/kernel": (L, d, ff),
        "block/mlp_out/kernel": (L, ff, d),
        "block/ln1/scale": (L, d),
        "block/ln2/scale": (L, d),
        "ln_f/scale": (d,),
    }
    if cfg.activation == "swiglu":
        shapes["block/mlp_gate/kernel"] = (L, d, ff)
    if cfg.use_wpe:
        shapes["wpe/embedding"] = (cfg.max_seq_len, d)
    if not cfg.tie_embeddings:
        shapes["lm_head/kernel"] = (d, V)
    return shapes


def params_from_numpy(tree: Dict, cfg: Union[GPTConfig, BertConfig],
                      device=None, dtype: torch.dtype = torch.float32) -> Dict:
    """Nested dicts of numpy arrays (the JAX ``gpt.init_params`` or
    ``bert.init_params`` layout) -> the port's parameters: the same tree of
    tensors on ``device``, floating leaves in ``dtype`` except the fp32
    ``scale`` of an int8 entry. A leaf may also be a tensor already (as
    ``runtime.checkpointing.load_16bit_model`` gives them, bf16
    included). Raises on a missing or misshapen weight, and on MoE blocks,
    whose slice has not been ported."""
    device = resolve_device(device)
    if "moe" in tree.get("block", {}):
        raise NotImplementedError("MoE blocks wait for the MoE slice")

    def walk(node, keep_dtype=False):
        if isinstance(node, dict):
            return {k: walk(v, k == "scale" and "q" in node)
                    for k, v in node.items()}
        if isinstance(node, torch.Tensor):
            t = node.detach().clone()
            return (t.to(dtype) if t.is_floating_point() and not keep_dtype
                    else t).to(device)
        a = np.asarray(node)
        floating = np.issubdtype(a.dtype, np.floating) \
            or a.dtype.name == "bfloat16"     # ml_dtypes' bf16 is not np.floating
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)          # exact: bf16 widens losslessly
        t = torch.from_numpy(np.array(a, order="C"))   # a writable copy
        if floating and not keep_dtype:
            t = t.to(dtype)
        return t.to(device)

    out = walk(tree)
    expected = _bert_shapes(cfg, "qa" in tree) \
        if isinstance(cfg, BertConfig) else _expected_shapes(cfg)
    for path, shape in expected.items():
        node = out
        parts = path.split("/")
        for key in parts[:-1]:
            if key not in node:
                raise ValueError(f"parameter {path} missing from the tree")
            node = node[key]
        leaf = parts[-1]
        if leaf == "kernel" and "q" in node:          # an int8 entry
            leaf, path = "q", path[:-len("kernel")] + "q"
            scale = node.get("scale")
            want = shape[:-2] + (1, shape[-1])
            if scale is None or tuple(scale.shape) != want \
                    or scale.dtype != torch.float32 \
                    or node["q"].dtype != torch.int8:
                raise ValueError(f"int8 entry {path}: expected int8 codes "
                                 f"and float32 scales of shape {want}")
        if leaf not in node:
            raise ValueError(f"parameter {path} missing from the tree")
        if tuple(node[leaf].shape) != shape:
            raise ValueError(f"parameter {path} has shape "
                             f"{tuple(node[leaf].shape)}, expected {shape}")
    return out


def params_to_numpy(tree: Dict) -> Dict:
    """The inverse of :func:`params_from_numpy` for parameters, gradients
    and updated parameters: the same nested dicts with float32 numpy
    leaves (bf16 and fp16 widen exactly; integer leaves keep their type)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)
    return walk(tree)


def opt_state_from_numpy(count: int, mu: Dict, nu: Dict, device=None,
                         dtype: torch.dtype = torch.float32) -> Dict:
    """The JAX package's ``ScaleByAdamState(count, mu, nu)`` as numpy ->
    the port's Adam state ``{"count", "mu", "nu"}`` on ``device`` with the
    moments in ``dtype``."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        a = np.asarray(node)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a, order="C")).to(device=device,
                                                           dtype=dtype)
    return {"count": int(count), "mu": walk(mu), "nu": walk(nu)}


def opt_state_to_numpy(state: Dict):
    """The port's Adam state -> ``(count, mu, nu)`` with numpy leaves."""
    return (int(state["count"]), params_to_numpy(state["mu"]),
            params_to_numpy(state["nu"]))
