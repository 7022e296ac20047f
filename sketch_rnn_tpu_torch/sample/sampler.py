"""Stroke-5 start and end tokens.

The constants of ``sketch_rnn_tpu/sample/sampler.py`` the serving engine
uses; the batch sampler itself comes with a later slice.
"""

import torch

END_TOKEN = torch.tensor([0.0, 0.0, 0.0, 0.0, 1.0], dtype=torch.float32)
START_TOKEN = torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0], dtype=torch.float32)
