"""Warm starts (counterpart of ``tggcn/train/checkpoint.py:183``).

Stage 2 starts from a stage-1 run's weights: ``merge_params`` is the
reference's non-strict ``load_state_dict(strict=False)`` over parameter
trees. Reading run directories (``.ckpt`` and reference ``.tar`` files) is
not ported yet.
"""


def merge_params(init_params, loaded):
    """init_params with every leaf that loaded has at the same path and
    with the same shape taken from loaded; the rest kept.

    A list (an MLP's layers) has no shape of its own and is taken whole
    from loaded, as the JAX package's merge_params takes it.
    """
    if not isinstance(init_params, dict) or not isinstance(loaded, dict):
        if getattr(init_params, "shape", None) == getattr(loaded, "shape", None):
            return loaded
        return init_params
    return {k: merge_params(v, loaded[k]) if k in loaded else v
            for k, v in init_params.items()}


def count_merged(init_params, merged) -> int:
    """The number of tensor leaves of merged that are not init_params's own."""
    if isinstance(merged, dict):
        return sum(count_merged(init_params.get(k) if isinstance(init_params, dict) else None, v)
                   for k, v in merged.items())
    if isinstance(merged, (list, tuple)):
        own = init_params if isinstance(init_params, (list, tuple)) else ()
        return sum(count_merged(own[i] if i < len(own) else None, v)
                   for i, v in enumerate(merged))
    return int(merged is not init_params)
