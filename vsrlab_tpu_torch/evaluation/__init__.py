"""Serving and evaluation entry points of the port: the harness (run
directories, forwards, the fps x crf sweep), the parameter / speed bench
and tiled inference.

``evaluation.upscale`` (the video -> video CLI) and ``evaluation.export``
are not imported here: ``python -m vsrlab_tpu_torch.evaluation.upscale``
would warn about a module already in ``sys.modules``. Import them directly.
"""

from vsrlab_tpu_torch.evaluation.harness import (
    load_test_model,
    run_test_matrix,
    windowed_inference,
)
from vsrlab_tpu_torch.evaluation.params_bench import param_count, speed_bench
from vsrlab_tpu_torch.evaluation.tiled import tiled_forward

__all__ = [
    "load_test_model",
    "windowed_inference",
    "run_test_matrix",
    "param_count",
    "speed_bench",
    "tiled_forward",
]
