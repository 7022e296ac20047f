"""Port of ``sketch_rnn_tpu.data``: the stroke utilities, the loader and
the QuickDraw ndjson conversion, under the JAX package's twelve names."""
from sketch_rnn_tpu_torch.data.strokes import (
    augment_strokes,
    calculate_normalizing_scale_factor,
    normalize_strokes,
    random_scale,
    strokes_to_lines,
    to_big_strokes,
    to_normal_strokes,
)
from sketch_rnn_tpu_torch.data.loader import (
    DataLoader,
    load_dataset,
    make_synthetic_strokes,
)
from sketch_rnn_tpu_torch.data.quickdraw import (convert_ndjson,
                                                 drawing_to_stroke3)

__all__ = [
    "DataLoader",
    "convert_ndjson",
    "drawing_to_stroke3",
    "augment_strokes",
    "calculate_normalizing_scale_factor",
    "load_dataset",
    "make_synthetic_strokes",
    "normalize_strokes",
    "random_scale",
    "strokes_to_lines",
    "to_big_strokes",
    "to_normal_strokes",
]
