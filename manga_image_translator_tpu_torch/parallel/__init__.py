from .mesh import (
    make_mesh,
    pipeline_step,
    shard_ocr_params_tp,
    train_step_dbnet,
)
