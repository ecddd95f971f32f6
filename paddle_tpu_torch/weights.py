"""Weights across the two packages: a LLaMA state dict as numpy arrays (the
JAX model's `state_dict()`, each value turned into an array) onto the
port's modules (`load_llama_state`), and back (`llama_state_to_numpy`, so
trained parameters can be compared with the JAX model's); the same for the
incubate fused layers, `FusedMultiTransformer`'s per-layer lists
(`qkv_weights.0`, ...) and the `nn/transformer.py` layers, any module whose
names equal the JAX layer's (`fused_encoder_state_from_numpy`,
`fused_encoder_state_to_numpy`); and a GPT state (`gpt_state_from_numpy`,
`gpt_state_to_numpy`, `load_gpt_state`).

The port keeps the JAX model's parameter names and Paddle's [in, out]
layout for linears, so the map is one to one; these functions check that
every expected name is present with its shape and that nothing is left
over, then convert. A weight-only quantized linear carries its int8
`quant_weight` and f32 `weight_scale` in place of `weight` (both packages'
`quantize_for_inference`); loading such a state needs a port model
quantized with the same algorithm and group size.

Tensor parallelism: a model built at tensor-parallel degree tp > 1 holds
this rank's shards (`distributed/fleet/layers/mpu/mp_layers.py`), where the
reference's state holds full arrays. `llama_state_from_numpy` /
`gpt_state_from_numpy` take `tp_rank` / `tp_degree` and slice a full state
into that rank's shards (`load_*_state` slices for the model's own rank),
`*_state_to_numpy` returns a rank's shards, and `gather_llama_state` /
`gather_gpt_state` build the full state back from every rank's, in
tensor-parallel rank order. The split axis of a weight (`tp_split_axis`)
is its layer's: a column-parallel weight and bias by columns, a
row-parallel weight and a vocab-parallel embedding by rows; everything
else is replicated.

ZeRO stage 3: a model whose parameters a stage-3 engine stores as slices
(`distributed/fleet/meta_parallel/sharding/`) holds only this rank's piece
of each. `*_state_to_numpy` then returns the pieces (1-D arrays) with a
`ZERO_KEY` entry naming each piece's range of the flattened (tensor-parallel
shard of the) weight and the rank's tensor-parallel coordinate;
`gather_*_state` joins every rank's pieces, then the tensor-parallel
shards, into the full state; `load_*_state` writes a full state into the
rank's pieces.

Pipeline parallelism: a model built at pp degree S > 1 holds its stage's
parameters under the whole model's names (`llama.layers.5...`: the layers
of `distributed.pipeline.stage_layer_ids`, the embedding on the first
stage, the final norm and head on the last, a tied embedding on both).
`*_state_from_numpy` take `pp_stage` / `pp_degree` / `virtual_pp_degree`
and keep that stage's part of a full state (`load_*_state` for the
model's own stage); `*_state_to_numpy` return the stage's part with a
`PP_KEY` entry naming the stage and the tensor-parallel coordinate; and
`gather_*_state` joins every rank's (any order, dp replicas equal; a
weight two stages hold must be equal on both) into the full state.
`paddle_tpu_torch.save` of a pp model's state writes one file a rank until
`distributed/checkpoint.py`.
"""
from __future__ import annotations

import numpy as np
import torch

from .framework.device import resolve_device

# the entry of a stage-3 rank's numpy state that describes its pieces
ZERO_KEY = "@zero"
# the entry of a pipeline stage's numpy state that names the stage
PP_KEY = "@pp"

# the tensor-parallel split of each weight, by the end of its name: 1 for a
# column-parallel weight, 0 for a row-parallel weight, a vocab-parallel
# embedding and a column-parallel bias; absent: replicated
_TP_SPLIT = {
    "embed_tokens.weight": 0, "lm_head.weight": 1,
    "q_proj.weight": 1, "k_proj.weight": 1, "v_proj.weight": 1,
    "gate_proj.weight": 1, "up_proj.weight": 1,
    "o_proj.weight": 0, "down_proj.weight": 0,
    "qkv_proj.weight": 1, "qkv_proj.bias": 0, "fc_in.weight": 1,
    "fc_in.bias": 0, "out_proj.weight": 0, "fc_out.weight": 0,
}


def tp_split_axis(name):
    """The axis a tensor-parallel model splits weight `name` along, or
    None for a replicated one."""
    for suffix, axis in _TP_SPLIT.items():
        if name.endswith("." + suffix) or name == suffix:
            return axis
    return None


def _tp_shapes(shapes, tp):
    """`shapes` with each split axis divided by `tp` (raising where tp
    does not divide it)."""
    out = {}
    for name, shape in shapes.items():
        ax = tp_split_axis(name)
        if ax is not None and tp > 1:
            if shape[ax] % tp:
                raise ValueError(f"{name}: axis {ax} of {shape} is not "
                                 f"divisible by the tensor-parallel degree "
                                 f"{tp}")
            shape = shape[:ax] + (shape[ax] // tp,) + shape[ax + 1:]
        out[name] = shape
    return out


def _tp_slice(name, arr, tp_rank, tp_degree):
    ax = tp_split_axis(name)
    if ax is None or tp_degree == 1:
        return arr
    n = arr.shape[ax] // tp_degree
    idx = [slice(None)] * arr.ndim
    idx[ax] = slice(tp_rank * n, (tp_rank + 1) * n)
    return arr[tuple(idx)]


def _gather(states, shapes, family):
    """The full state from every tensor-parallel rank's shards (rank
    order), checked against `shapes`; a replicated array must be equal on
    every rank."""
    tp = len(states)
    want = _tp_shapes(shapes, tp)
    for r, st in enumerate(states):
        if set(st) != set(shapes):
            raise KeyError(f"{family} state of rank {r}: missing "
                           f"{sorted(set(shapes) - set(st))}, unexpected "
                           f"{sorted(set(st) - set(shapes))}")
        for name, shape in want.items():
            if tuple(np.shape(st[name])) != shape:
                raise ValueError(f"rank {r}: {name} has shape "
                                 f"{np.shape(st[name])}, expected {shape}")
    out = {}
    for name in shapes:
        ax = tp_split_axis(name)
        parts = [np.asarray(st[name]) for st in states]
        if ax is None:
            for r, a in enumerate(parts[1:], 1):
                if not np.array_equal(a, parts[0]):
                    raise ValueError(f"{name}: replicated, but rank {r}'s "
                                     "differs from rank 0's")
            out[name] = parts[0]
        else:
            out[name] = np.concatenate(parts, axis=ax)
    return out


def _layer_index(name):
    parts = name.split(".")
    if len(parts) > 2 and parts[1] == "layers":
        return int(parts[2])
    return None


def stage_names(names, config, stage, num_stages, virtual=1):
    """The names of `names` (a LLaMA's or GPT's) that pipeline rank
    `stage` of `num_stages` holds: its layers (`stage_layer_ids`), the
    embeddings on the first stage (the token embedding also on the last
    with a tied head), the final norm and the head on the last."""
    from .distributed.pipeline import stage_layer_ids

    if num_stages <= 1:
        return list(names)
    ids = set(stage_layer_ids(config.num_hidden_layers, stage, num_stages,
                              virtual))
    first, last = stage == 0, stage == num_stages - 1
    out = []
    for n in names:
        i = _layer_index(n)
        if i is not None:
            keep = i in ids
        elif n.endswith("embed_tokens.weight"):
            keep = first or (last and config.tie_word_embeddings)
        elif n.endswith("embed_positions.weight"):
            keep = first
        else:  # the final norm, the head
            keep = last
        if keep:
            out.append(n)
    return out


def _pp_entry(model):
    pp = model.pp
    return {"stage": pp.stage, "pp_degree": pp.num_stages,
            "virtual": pp.virtual, "tp_rank": int(model.tp_rank),
            "tp_degree": int(model.tp_degree)}


def _join_pp(states, shapes):
    """`states` of pipeline stages (any order; dp replicas too) as the
    tensor-parallel rank states (rank order) of the whole model; every
    name covered, every copy equal. States without `PP_KEY` pass as they
    are."""
    if not states or PP_KEY not in states[0]:
        return states
    tp = states[0][PP_KEY]["tp_degree"]
    out = []
    for t in range(tp):
        group = [st for st in states if st[PP_KEY]["tp_rank"] == t]
        joined = {}
        for name in shapes:
            held = [np.asarray(st[name]) for st in group if name in st]
            if not held:
                raise KeyError(f"{name}: no pipeline stage of "
                               f"tensor-parallel rank {t} holds it")
            for a in held[1:]:
                if not np.array_equal(a, held[0]):
                    raise ValueError(f"{name}: the copies of two pipeline "
                                     "stages (or dp replicas) differ")
            joined[name] = held[0]
        out.append(joined)
    return out


def llama_param_shapes(config) -> dict:
    """name -> shape of every parameter of `LlamaForCausalLM(config)`."""
    h, i, v = config.hidden_size, config.intermediate_size, config.vocab_size
    hd = h // config.num_attention_heads
    q, kv = config.num_attention_heads * hd, config.num_key_value_heads * hd
    shapes = {"llama.embed_tokens.weight": (v, h)}
    for n in range(config.num_hidden_layers):
        p = f"llama.layers.{n}."
        shapes.update({
            p + "input_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (h, q),
            p + "self_attn.k_proj.weight": (h, kv),
            p + "self_attn.v_proj.weight": (h, kv),
            p + "self_attn.o_proj.weight": (q, h),
            p + "post_attention_layernorm.weight": (h,),
            p + "mlp.gate_proj.weight": (h, i),
            p + "mlp.up_proj.weight": (h, i),
            p + "mlp.down_proj.weight": (i, h),
        })
    shapes["llama.norm.weight"] = (h,)
    if not config.tie_word_embeddings:
        shapes["lm_head.weight"] = (h, v)
    return shapes


def _layout(config, names):
    """name -> the float shape it stands for, for a state holding `names`: a
    linear's `<p>.weight` [k, n] may instead be `<p>.quant_weight` and
    `<p>.weight_scale` (both mapped to [k, n]), where the state holds
    those."""
    out = {}
    for name, shape in llama_param_shapes(config).items():
        p = name[:-len("weight")]
        if len(shape) == 2 and name != "llama.embed_tokens.weight" and \
                p + "quant_weight" in names:
            out[p + "quant_weight"] = out[p + "weight_scale"] = shape
        else:
            out[name] = shape
    return out


def _check_quant(name, qw, scale, shape):
    """A quantized linear of float shape [k, n]: int8 [k, n] or packed int4
    [k // 2, n], f32 scales [n] or [groups, n] with groups dividing k."""
    k, n = shape
    ok = (qw.dtype == np.int8 and qw.ndim == 2 and qw.shape[1] == n
          and qw.shape[0] in (k, k // 2) and scale.dtype == np.float32
          and (scale.shape == (n,) or (scale.ndim == 2 and scale.shape[1] == n
                                       and k % scale.shape[0] == 0)))
    if not ok:
        raise ValueError(f"{name}: quantized weight {qw.dtype} "
                         f"{qw.shape} with scales {scale.dtype} "
                         f"{scale.shape} does not fit [{k}, {n}]")


def llama_state_from_numpy(state, config, dtype=torch.float32, device=None,
                           tp_rank=0, tp_degree=1, pp_stage=0, pp_degree=1,
                           virtual_pp_degree=1):
    """{name: np.ndarray} -> {name: torch.Tensor} on `device`, after
    checking the names and shapes against `config`. Float weights become
    `dtype`; a quantized linear (`<p>.quant_weight` int8 and
    `<p>.weight_scale` f32 in place of `<p>.weight`, as the JAX
    `quantize_for_inference` leaves them) keeps its int8 and f32. With
    `tp_degree` > 1, the full float state is sliced into rank `tp_rank`'s
    shards; with `pp_degree` > 1, only the names pipeline rank `pp_stage`
    holds are kept (`stage_names`)."""
    layout = _layout(config, set(state))
    if tp_degree > 1 and layout.keys() != llama_param_shapes(config).keys():
        raise NotImplementedError(
            "llama_state_from_numpy: slicing a quantized state into "
            "tensor-parallel shards is not ported (ROADMAP Queue 1 item 4); "
            "load the float state and quantize the shards "
            "(nn.quant.quantize_for_inference), which gives each rank the "
            "slice of the whole weight's quantization")
    missing = sorted(set(layout) - set(state))
    extra = sorted(set(state) - set(layout))
    if missing or extra:
        raise KeyError(f"LLaMA state dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    dev = resolve_device(device)
    keep = set(stage_names(layout, config, pp_stage, pp_degree,
                           virtual_pp_degree))
    out = {}
    for name in layout:
        if name not in keep:
            continue
        arr = np.asarray(state[name])
        if name.endswith(".quant_weight"):
            p = name[:-len("quant_weight")]
            scale = np.asarray(state[p + "weight_scale"])
            _check_quant(p + "weight", arr, scale, layout[name])
            out[name] = torch.from_numpy(np.array(arr)).to(dev)
            out[p + "weight_scale"] = torch.from_numpy(
                np.array(scale)).to(dev)
        elif not name.endswith(".weight_scale"):
            if arr.shape != layout[name]:
                raise ValueError(f"{name}: shape {arr.shape}, expected "
                                 f"{layout[name]}")
            arr = _tp_slice(name, arr, tp_rank, tp_degree)
            out[name] = torch.from_numpy(
                np.array(arr, dtype=np.float32)).to(dev, dtype)
    return out


def llama_state_to_numpy(model):
    """The weights of a port `LlamaForCausalLM` as {name: np.ndarray}: float
    weights in f32 (the inverse of `load_llama_state` on an f32 model),
    quantized linears as their int8 `quant_weight` and f32 `weight_scale`;
    checked against the LLaMA layout of the model's config. At
    tensor-parallel degree > 1, this rank's shards (`gather_llama_state`
    joins the ranks'); under ZeRO stage 3, this rank's pieces
    (`ZERO_KEY`)."""
    if _zero3(model) is not None:
        return _zero_pieces(model)
    state = {}
    for n, t in model.state_dict().items():
        t = t.detach().cpu()
        state[n] = (t if t.dtype == torch.int8 else t.float()).numpy()
    if model.pp.split:
        _check_stage(state, llama_param_shapes(model.config), model,
                     "LLaMA")
        state[PP_KEY] = _pp_entry(model)
    elif model.tp_degree > 1:
        _gather([state], _tp_shapes(llama_param_shapes(model.config),
                                    model.tp_degree), "LLaMA")  # the check
    else:
        llama_state_from_numpy(state, model.config, device="cpu")
    return state


def _check_stage(state, shapes, model, family):
    """A pipeline stage's state: the stage's names, each of its
    tensor-parallel shard's shape."""
    pp = model.pp
    names = stage_names(shapes, model.config, pp.stage, pp.num_stages,
                        pp.virtual)
    _gather([state], _tp_shapes({n: shapes[n] for n in names},
                                model.tp_degree), family)


def gather_llama_state(states, config):
    """The full LLaMA state from every tensor-parallel rank's
    `llama_state_to_numpy` (in rank order), or from every rank's pieces
    under ZeRO stage 3, or every pipeline rank's stage (any order)."""
    shapes = llama_param_shapes(config)
    return _gather(_join_pp(_join_zero(states, shapes), shapes), shapes,
                   "LLaMA")


def load_llama_state(model, state):
    """Replace the weights of a port `LlamaForCausalLM` by `state`
    ({name: np.ndarray}, the full state), in the model's dtype and on its
    device; at tensor-parallel degree > 1, its rank's shards; under ZeRO
    stage 3, its rank's pieces of them."""
    ref = model._ref_param()  # dtype and device: metadata
    pp = model.pp
    tensors = llama_state_from_numpy(state, model.config, ref.dtype,
                                     ref.device, model.tp_rank,
                                     model.tp_degree, pp.stage,
                                     pp.num_stages, pp.virtual)
    return _load(model, tensors)


def fused_encoder_state_from_numpy(state, module):
    """{name: np.ndarray} (a JAX layer's state: an incubate layer such as
    `FusedTransformerEncoderLayer` or `FusedMultiTransformer`, a
    `nn/transformer.py` layer, or a stack of them) -> {name: torch.Tensor}
    for the port's `module` of the
    same structure, each in its parameter's dtype and on its device, after
    checking that names and shapes agree; load it with
    `module.load_state_dict`."""
    want = module.state_dict()
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise KeyError(f"fused encoder state mismatch: missing {missing}, "
                       f"unexpected {extra}")
    out = {}
    for name, ref in want.items():
        arr = np.asarray(state[name], dtype=np.float32)
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{name}: shape {arr.shape}, expected "
                             f"{tuple(ref.shape)}")
        out[name] = torch.from_numpy(np.array(arr)).to(ref.device, ref.dtype)
    return out


def fused_encoder_state_to_numpy(module):
    """The parameters of a port incubate layer as {name: np.ndarray} in
    f32, named as the JAX layer's."""
    return {n: t.detach().cpu().float().numpy()
            for n, t in module.state_dict().items()}


def gpt_param_shapes(config) -> dict:
    """name -> shape of every parameter of `GPTForCausalLM(config)` (the
    reference's names)."""
    h, i, v = config.hidden_size, config.intermediate_size, config.vocab_size
    shapes = {"gpt.embed_tokens.weight": (v, h),
              "gpt.embed_positions.weight": (config.max_position_embeddings,
                                             h)}
    for n in range(config.num_hidden_layers):
        p = f"gpt.layers.{n}."
        for name, w in (("ln_1", None), ("attn.qkv_proj", (h, 3 * h)),
                        ("attn.out_proj", (h, h)), ("ln_2", None),
                        ("mlp.fc_in", (h, i)), ("mlp.fc_out", (i, h))):
            shapes[p + name + ".weight"] = w or (h,)
            shapes[p + name + ".bias"] = (w[1],) if w else (h,)
    shapes["gpt.ln_f.weight"] = shapes["gpt.ln_f.bias"] = (h,)
    if not config.tie_word_embeddings:
        shapes["lm_head.weight"] = (h, v)
    return shapes


def gpt_state_from_numpy(state, config, dtype=torch.float32, device=None,
                         tp_rank=0, tp_degree=1, pp_stage=0, pp_degree=1,
                         virtual_pp_degree=1):
    """{name: np.ndarray} (the JAX GPT's state) -> {name: torch.Tensor} in
    `dtype` on `device`, after checking every name and shape against
    `config`; with `tp_degree` > 1, rank `tp_rank`'s shards; with
    `pp_degree` > 1, only the names pipeline rank `pp_stage` holds."""
    shapes = gpt_param_shapes(config)
    missing = sorted(set(shapes) - set(state))
    extra = sorted(set(state) - set(shapes))
    if missing or extra:
        raise KeyError(f"GPT state dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    dev = resolve_device(device)
    keep = set(stage_names(shapes, config, pp_stage, pp_degree,
                           virtual_pp_degree))
    out = {}
    for name, shape in shapes.items():
        if name not in keep:
            continue
        arr = np.asarray(state[name], dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        arr = _tp_slice(name, arr, tp_rank, tp_degree)
        out[name] = torch.from_numpy(np.array(arr)).to(dev, dtype)
    return out


def gpt_state_to_numpy(model):
    """The weights of a port `GPTForCausalLM` as {name: np.ndarray} in f32
    (copies: a later step does not move them), checked against the GPT
    layout of its config; at tensor-parallel degree > 1, this rank's
    shards."""
    if _zero3(model) is not None:
        return _zero_pieces(model)
    state = {n: np.array(t.detach().cpu().float().numpy())
             for n, t in model.state_dict().items()}
    if model.pp.split:
        _check_stage(state, gpt_param_shapes(model.config), model, "GPT")
        state[PP_KEY] = _pp_entry(model)
        return state
    _gather([state], _tp_shapes(gpt_param_shapes(model.config),
                                model.tp_degree), "GPT")  # the check
    return state


def gather_gpt_state(states, config):
    """The full GPT state from every tensor-parallel rank's
    `gpt_state_to_numpy` (in rank order), or from every rank's pieces
    under ZeRO stage 3, or every pipeline rank's stage (any order)."""
    shapes = gpt_param_shapes(config)
    return _gather(_join_pp(_join_zero(states, shapes), shapes), shapes,
                   "GPT")


def load_gpt_state(model, state):
    """Replace the weights of a port `GPTForCausalLM` by `state` ({name:
    np.ndarray}, the full state), in the model's dtype and on its device;
    at tensor-parallel degree > 1, its rank's shards."""
    ref = model._ref_param()
    pp = model.pp
    return _load(model, gpt_state_from_numpy(
        state, model.config, ref.dtype, ref.device, model.tp_rank,
        model.tp_degree, pp.stage, pp.num_stages, pp.virtual))


# ---------------------------------------------------------------------------
# ZeRO stage 3: a rank's pieces


def _zero3(model):
    """The stage-3 ZeRO engine that stores `model`'s parameters as slices,
    or None."""
    eng = getattr(model, "_zero_engine", None)
    return eng if eng is not None and eng.stage == 3 else None


def _load(model, tensors):
    eng = _zero3(model)
    if eng is None:
        model.load_state_dict(tensors, strict=True)
        return model
    params = dict(model.named_parameters())
    if set(params) != set(tensors):
        raise KeyError(f"state dict mismatch: missing "
                       f"{sorted(set(params) - set(tensors))}, unexpected "
                       f"{sorted(set(tensors) - set(params))}")
    for n, p in params.items():
        eng.load_param(p, tensors[n])
    return model


def _zero_pieces(model):
    """{name: this rank's piece (1-D f32)} and `ZERO_KEY`: {"tp_rank",
    "tp_degree", "pieces": {name: (lo, hi, shape)}}."""
    eng = _zero3(model)
    state, pieces = {}, {}
    for n, p in model.named_parameters():
        lo, hi, values = eng.piece_of(p)
        state[n] = values.detach().cpu().float().numpy().copy()
        pieces[n] = (int(lo), int(hi), tuple(p.shape))
    state[ZERO_KEY] = {"tp_rank": int(model.tp_rank),
                       "tp_degree": int(model.tp_degree), "pieces": pieces}
    if model.pp.split:
        state[PP_KEY] = _pp_entry(model)
    return state


def _join_zero(states, shapes):
    """`states` as tensor-parallel rank states (rank order): stage-3 pieces
    joined (a dp replica's pieces must equal; every element covered; each
    name from the pipeline stages that hold it), other states as they
    are."""
    if not states or ZERO_KEY not in states[0]:
        return states
    tp = states[0][ZERO_KEY]["tp_degree"]
    want = _tp_shapes(shapes, tp)
    out = []
    for t in range(tp):
        group = [st for st in states if st[ZERO_KEY]["tp_rank"] == t]
        joined = {}
        for name, shape in want.items():
            flat = np.zeros(int(np.prod(shape)), dtype=np.float32)
            seen = np.zeros(flat.shape, dtype=bool)
            for st in group:
                if name not in st[ZERO_KEY]["pieces"]:
                    continue  # another pipeline stage's
                lo, hi, got_shape = st[ZERO_KEY]["pieces"][name]
                if tuple(got_shape) != tuple(shape):
                    raise ValueError(f"{name}: a piece of shape {got_shape}, "
                                     f"expected {shape}")
                piece = np.asarray(st[name])
                both = seen[lo:hi]
                if both.any() and not np.array_equal(flat[lo:hi][both],
                                                      piece[both]):
                    raise ValueError(f"{name}: replicas' pieces differ")
                flat[lo:hi] = piece
                seen[lo:hi] = True
            if not seen.all():
                raise ValueError(f"{name}: the pieces of tensor-parallel "
                                 f"rank {t} do not cover it")
            joined[name] = flat.reshape(shape)
        out.append(joined)
    return out



def _whole_shapes(model):
    """name -> whole shape of a LLaMA's or GPT's parameters, or None for
    another model."""
    from .models.gpt import GPTConfig
    from .models.llama import LlamaConfig

    cfg = getattr(model, "config", None)
    if isinstance(cfg, LlamaConfig):
        return llama_param_shapes(cfg)
    if isinstance(cfg, GPTConfig):
        return gpt_param_shapes(cfg)
    return None


def _named_tensors(model):
    """(name, tensor, is parameter) of every parameter and persistent
    buffer of `model`, under the whole model's names. A `PipelineLayer`
    names each entry's tensors by the entry's index among its descs
    (`_layer_list.<i>.*`, the same on every stage and at every pipeline
    degree) and a module that several entries use (a shared layer) under
    each of them, as Paddle's pipeline saves a layer a desc; any other
    model by its own names (a LLaMA or GPT stage keeps the whole model's
    layer numbers)."""
    from .distributed.fleet.meta_parallel.pp_layers import PipelineLayer

    params = dict(model.named_parameters())
    buffers = [(n, t) for n, t in model.state_dict(keep_vars=True).items()
               if n not in params]
    if not isinstance(model, PipelineLayer):
        return [(n, p, True) for n, p in params.items()] + \
            [(n, t, False) for n, t in buffers]
    out, seen = [], set()
    for i, (mod, _) in zip(model._held, model.run_function):
        if not isinstance(mod, torch.nn.Module):
            continue
        own = dict(mod.named_parameters())
        for n, t in mod.state_dict(keep_vars=True).items():
            out.append((f"_layer_list.{i}.{n}", t, n in own))
            seen.add(id(t))
    # what lies outside the entries (a loss module's state): its own name
    out += [(n, p, True) for n, p in params.items() if id(p) not in seen]
    out += [(n, t, False) for n, t in buffers if id(t) not in seen]
    return out


def _shard_of(name, p):
    """(split axis, whole shape, rank, degree) of a tensor-parallel layer's
    shard (`is_distributed`, placed by mp_layers' `split_axis` and
    `tp_shard`); (None, its shape, 0, 1) for a whole tensor."""
    from .distributed.fleet.layers.mpu.mp_layers import is_distributed

    if not is_distributed(p):
        return None, tuple(p.shape), 0, 1
    ax, place = getattr(p, "split_axis", None), getattr(p, "tp_shard", None)
    if ax is None or place is None:
        raise ValueError(
            f"{name}: a tensor-parallel shard (is_distributed) without "
            "`split_axis` and `tp_shard`; its block of the whole tensor is "
            "unknown, so it cannot be saved under the whole model's name "
            "(build it with a tensor-parallel layer of fleet.meta_parallel)")
    rank, degree = place
    shape = list(p.shape)
    shape[ax] *= degree
    return ax, tuple(shape), rank, degree


def param_pieces(model):
    """{name: (tensor, whole shape, box, flat)}: every parameter (and
    persistent buffer) of `model` as this rank holds it, under the whole
    model's names (`_named_tensors`): a tensor-parallel shard as its block
    of the whole tensor (`box`: (start, size) per dimension; a LLaMA's or
    GPT's by `tp_split_axis`, another model's by its layer's `split_axis`
    and `tp_shard`), a ZeRO stage-3 parameter as its piece `flat` = (lo,
    hi) of that block flattened (the tensor is the piece). A buffer is
    whole (box None)."""
    shapes = _whole_shapes(model)
    eng = _zero3(model)
    out = {}
    for n, p, is_param in _named_tensors(model):
        if not is_param:
            out[n] = (p.detach(), tuple(p.shape), None, None)
            continue
        local = tuple(p.shape)
        if shapes is not None:
            shape, ax = tuple(shapes[n]), tp_split_axis(n)
            rank = int(getattr(model, "tp_rank", 0) or 0)
            tp = int(getattr(model, "tp_degree", 1) or 1)
        else:
            ax, shape, rank, tp = _shard_of(n, p)
        box = [(0, s) for s in shape]
        if ax is not None and tp > 1:
            box[ax] = (rank * local[ax], local[ax])
        if tuple(s for _, s in box) != local:
            raise ValueError(f"{n}: held as {local}, a block {box} of "
                             f"{shape} expected")
        if eng is not None:
            lo, hi, values = eng.piece_of(p)
            out[n] = (values, shape, tuple(box), (lo, hi))
        else:
            out[n] = (p.detach(), shape, tuple(box), None)
    return out


def param_names(model):
    """{id(parameter): [its names in `param_pieces`]}: one a desc that uses
    it for a `PipelineLayer`'s shared layer, else one."""
    out = {}
    for n, p, is_param in _named_tensors(model):
        if is_param:
            out.setdefault(id(p), []).append(n)
    return out


@torch.no_grad()
def set_param_pieces(model, values):
    """Write {name: tensor} (each at the place `param_pieces` gives the
    name on this rank) into `model`'s parameters and buffers; a tensor
    under several names (a shared layer's) takes its first name's."""
    eng = _zero3(model)
    entries = _named_tensors(model)
    missing = sorted(n for n, _, _ in entries if n not in values)
    if missing:
        raise KeyError(f"state mismatch: missing {missing[:4]}")
    done = set()
    for n, t, is_param in entries:
        if id(t) in done:
            continue
        done.add(id(t))
        v = torch.as_tensor(values[n])
        if is_param and eng is not None:
            _, _, piece = eng.piece_of(t)
            piece.copy_(v.reshape(-1).to(piece.device, piece.dtype))
        else:
            t.copy_(v.reshape(t.shape).to(t.device, t.dtype))
