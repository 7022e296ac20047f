"""Port of ``sketch_rnn_tpu.sample``: the sampler, latent interpolation
and SVG export."""

from sketch_rnn_tpu_torch.sample.sampler import (
    make_sampler,
    sample,
    sample_from_mixture,
)
from sketch_rnn_tpu_torch.sample.interpolate import (
    encode_mu,
    interpolate_latents,
    lerp,
    slerp,
)
from sketch_rnn_tpu_torch.sample.svg import strokes_to_svg, svg_grid

__all__ = [
    "make_sampler",
    "sample",
    "sample_from_mixture",
    "slerp",
    "lerp",
    "interpolate_latents",
    "encode_mu",
    "strokes_to_svg",
    "svg_grid",
]
