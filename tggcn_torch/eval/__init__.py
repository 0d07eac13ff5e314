"""Evaluation of a trained run dir (counterpart of ``tggcn/eval``):

    rundir     run-dir discovery (frozen config, checkpoint, scalers,
               class-name dictionaries, sibling CV folds)
    engine     batched inference on the model's device and the label-space
               post-processing
    reporting  frame metrics, F1@k, cross-validation aggregation, dumps
"""
