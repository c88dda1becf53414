"""TL001 — host-device synchronization inside hot-path loops.

The retrain-every-window pattern multiplies every per-iteration host
read by thousands of windows: a stray ``loss.item()`` or
``int(count_tensor)`` inside the boosting loop waits for the card to
drain its queue once per tree, and a captured chunk of trees can no
longer run ahead of the host.  This rule fires only in hot-path modules
(``context.HOT_PATH_SUFFIXES`` or a ``# torchlint: hot-path`` marker)
and only inside loops: module-level or once-per-call reads are fine.

Detected shapes, in a loop body:

- ``x.item()``, ``x.tolist()``, ``x.cpu()``, ``x.cpu().numpy()``: each
  copies a tensor to the host and waits for it (``item``/``tolist`` of a
  value known to be a numpy array are host reads and exempt; a bare
  ``t.numpy()`` is too, since torch refuses it for a tensor on the card:
  the copy is the ``.cpu()`` before it);
- ``torch.cuda.synchronize()`` and ``<event or stream>.synchronize()``;
- ``float(e)`` / ``int(e)`` / ``bool(e)`` where ``e`` contains a
  ``torch.``-rooted expression or a name locally assigned from one
  (metadata reads such as ``x.shape``, ``x.numel()`` or ``x.dtype`` are
  host-side and exempt);
- ``float(x[i])``-style scalar reads (a subscript argument) unless ``x``
  is known to be a numpy array: per-iteration scalar extraction;
- ``np.asarray(t)`` / ``np.array(t)`` of a (probable) tensor.

The torch analog of jaxlint's JL001: numpy values are told from tensors
by local dataflow (names assigned from ``np.``- or ``torch.``-rooted
expressions), so a numpy scalar read in a loop is not flagged.  Fix
patterns: keep the value on the card (a device control word, a masked
update), gather the values and read them once after the loop, or write a
justified ``# torchlint: disable=TL001`` where the read is the design
(the plain per-piece path reads its control words once a wave).
"""

from __future__ import annotations

import ast

from ..context import FileContext, dotted_name

CODE = "TL001"
SHORT = ("host-device sync inside a hot-path loop (.item()/.cpu()/"
         ".numpy()/.tolist()/synchronize()/int() of a tensor)")

_CASTS = ("float", "int", "bool")
#: tensor methods that copy to the host and wait for the card
_SYNC_METHODS = ("item", "tolist", "cpu")
#: tensor metadata: host-side attributes and methods, no transfer
_METADATA = ("shape", "ndim", "dtype", "size", "numel", "dim", "device",
             "stride", "strides", "is_cuda", "element_size", "nbytes",
             "itemsize", "layout", "requires_grad", "is_contiguous")
#: ``torch.<ns>.<fn>`` host queries that return Python values
_HOST_QUERIES = ("finfo", "iinfo", "device_count", "is_available",
                 "get_num_threads", "get_device_name", "current_device",
                 "memory_allocated", "max_memory_allocated",
                 "memory_reserved", "max_memory_reserved",
                 "get_device_properties", "is_tensor", "is_floating_point",
                 "device", "Size")


def _tensor_source(ctx: FileContext, node: ast.AST, tensor_names) -> bool:
    """Does ``node``'s subtree read a tensor's value: a torch-rooted
    expression (not a host query), or a locally tensor-assigned name
    (not a metadata read)?"""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Name):
            continue
        if sub.id in ctx.torch_aliases:
            top = sub
            while isinstance(ctx.parent(top), ast.Attribute):
                top = ctx.parent(top)
            d = dotted_name(top)
            if d is not None and d.split(".")[-1] in _HOST_QUERIES:
                continue
            return True
        if sub.id in tensor_names:
            parent = ctx.parent(sub)
            if isinstance(parent, ast.Attribute) \
                    and parent.attr in _METADATA:
                continue
            return True
    return False


def _classify(ctx: FileContext, call: ast.Call, tensor_names):
    func = call.func
    if isinstance(func, ast.Attribute):
        # x.item() / x.tolist() / x.cpu() / x.cpu().numpy()
        if func.attr == "numpy" and not (
                isinstance(func.value, ast.Call)
                and isinstance(func.value.func, ast.Attribute)
                and func.value.func.attr == "cpu"):
            return None
        if func.attr in _SYNC_METHODS + ("numpy",):
            if func.attr in ("item", "tolist") \
                    and (call.args or ctx.is_numpy_expr(func.value)):
                return None     # numpy's item(i) / a host array's read
            what = "cpu().numpy" if func.attr == "numpy" else func.attr
            return (f".{what}() copies a tensor to the host and "
                    "waits for the card every loop iteration; keep the "
                    "value on the device or gather the values and read "
                    "them once after the loop")
        if func.attr == "synchronize":
            return (f"`{dotted_name(func) or '.synchronize'}()` drains "
                    "the card's queue every loop iteration; synchronize "
                    "once after the loop (or not at all)")
    # float()/int()/bool() of a tensor value or of a subscript read
    if isinstance(func, ast.Name) and func.id in _CASTS \
            and len(call.args) == 1:
        arg = call.args[0]
        if _tensor_source(ctx, arg, tensor_names):
            return (f"{func.id}() of a tensor inside a loop waits for the "
                    "card each iteration; keep it on the device or read "
                    "the values once after the loop")
        if isinstance(arg, ast.Subscript):
            # x.shape[0] / x.strides[1] are host-side metadata, not reads
            if isinstance(arg.value, ast.Attribute) \
                    and arg.value.attr in _METADATA:
                return None
            if ctx.is_numpy_expr(arg.value):
                return None     # a numpy scalar read: host memory
            return (f"per-iteration scalar read {func.id}(...[...]) in a "
                    "hot loop; hoist the read out of the loop or read the "
                    "whole tensor once")
        return None
    # np.asarray(t) / np.array(t) of a tensor
    d = dotted_name(func)
    if d is not None and call.args and any(
            d in (f"{np}.asarray", f"{np}.array")
            for np in ctx.numpy_aliases) \
            and _tensor_source(ctx, call.args[0], tensor_names):
        return (f"{d}() of a tensor inside a loop is one blocking copy per "
                "iteration; gather on the device and copy once after the "
                "loop")
    return None


def check(ctx: FileContext):
    if not ctx.is_hot:
        return
    reported = []
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        if ctx.loop_depth(node) < 1:
            continue
        # a call nested inside an already-reported call (the .cpu()
        # inside int(t.cpu())) is the same sync
        if any(ctx.is_ancestor(r, node) or ctx.is_ancestor(node, r)
               for r in reported):
            continue
        msg = _classify(ctx, node, ctx.tensor_names(node))
        if msg is not None:
            reported.append(node)
            yield ctx.make_finding(CODE, node, msg)
