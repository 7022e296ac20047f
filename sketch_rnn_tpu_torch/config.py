"""Hyperparameter / config system of the PyTorch port.

A copy of ``sketch_rnn_tpu/config.py``: the same frozen dataclass, field
names, defaults, validation and ``key=value,key=value`` override grammar,
so a sidecar ``hps`` JSON written by either package loads in the other.
The port keeps its own copy rather than importing the JAX package's (the
port imports nothing of ``sketch_rnn_tpu``). Some fields configure parts
of the system the port does not run yet (telemetry, the speculative
draft, the fleet's later features); they are kept so the JSON
round-trips, and every field's meaning is documented once, in the JAX
package's copy. ``mesh_shape``/``mesh_axes`` lay out the ranks of the
process group (``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Tuple

CELL_TYPES = ("lstm", "layer_norm", "hyper")


@dataclasses.dataclass(frozen=True)
class HParams:
    """All knobs for data, model, loss, optimizer and parallelism."""

    # --- data ---
    data_dir: str = ""
    data_set: Tuple[str, ...] = ("cat.npz",)
    max_seq_len: int = 250
    batch_size: int = 100
    random_scale_factor: float = 0.15
    augment_stroke_prob: float = 0.10
    bucket_edges: Tuple[int, ...] = ()
    bucket_shuffle_window: int = 256
    bucket_run_len: int = 8

    # --- model ---
    conditional: bool = True           # seq2seq VAE vs decoder-only
    enc_model: str = "lstm"            # encoder cell: lstm | layer_norm | hyper
    dec_model: str = "lstm"            # decoder cell: lstm | layer_norm | hyper
    enc_rnn_size: int = 256            # per-direction encoder width
    dec_rnn_size: int = 512
    z_size: int = 128
    num_mixture: int = 20
    hyper_rnn_size: int = 256
    hyper_embed_size: int = 32
    num_classes: int = 0               # > 0: learned class embedding
    class_embed_size: int = 64         #   concatenated to decoder inputs

    # --- regularization ---
    use_recurrent_dropout: bool = True
    recurrent_dropout_keep: float = 0.90
    use_input_dropout: bool = False
    input_dropout_keep: float = 0.90
    use_output_dropout: bool = False
    output_dropout_keep: float = 0.90

    # --- VAE loss ---
    kl_weight: float = 0.5
    kl_weight_start: float = 0.01
    kl_decay_rate: float = 0.99995
    kl_tolerance: float = 0.20

    # --- optimizer ---
    learning_rate: float = 1e-3
    decay_rate: float = 0.9999
    min_learning_rate: float = 1e-5
    grad_clip: float = 1.0

    # --- training loop ---
    num_steps: int = 100000
    save_every: int = 500
    eval_every: int = 500
    log_every: int = 20
    prefetch_depth: int = 2
    steps_per_call: int = 1
    eval_steps_per_call: int = 8
    async_checkpoint: bool = True
    metrics_defer: bool = True
    ckpt_retries: int = 2
    ckpt_retry_backoff_s: float = 0.05
    resume_align: bool = True

    # --- precision / parallelism ---
    transfer_dtype: str = "float32"
    compute_dtype: str = "float32"     # matmul operand dtype ("bfloat16":
    #   bf16 operands, f32 accumulation, in every kernel)
    fused_rnn: bool = False
    fused_residual_dtype: str = "float32"
    remat: bool = False
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("data",)

    # --- serving (serve/engine.py: continuous-batching generation) ---
    serve_slots: int = 64              # decoder slots B resident at once
    serve_chunk: int = 8               # decode steps K per dispatch
    decode_kernel: str = "scan"        # the JAX package's chunk flavor
    #   ("scan" or "pallas"); the port accepts both names so sidecars
    #   load, and serves either through its one CUDA decode kernel
    serve_quantize: str = "float32"
    serve_prefix_edges: Tuple[int, ...] = ()  # encode-phase prefix pad
    #   ladder; empty = serve/endpoints.default_prefix_edges
    draft_rnn_size: int = 64
    draft_num_mixture: int = 0
    draft_depth: int = 32
    draft_tol: float = 0.35

    def __post_init__(self):
        if self.enc_model not in CELL_TYPES or self.dec_model not in CELL_TYPES:
            raise ValueError(
                f"cell types must be one of {CELL_TYPES}, got "
                f"enc={self.enc_model!r} dec={self.dec_model!r}")
        if self.batch_size <= 0 or self.max_seq_len <= 0:
            raise ValueError("batch_size and max_seq_len must be positive")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be 'float32' or 'bfloat16', got "
                f"{self.compute_dtype!r}")
        if self.transfer_dtype not in ("float32", "bfloat16", "int16"):
            raise ValueError(
                f"transfer_dtype must be 'float32', 'bfloat16' or "
                f"'int16', got {self.transfer_dtype!r}")
        if self.fused_residual_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"fused_residual_dtype must be 'float32' or 'bfloat16', "
                f"got {self.fused_residual_dtype!r}")
        if self.steps_per_call < 1:
            raise ValueError(
                f"steps_per_call must be >= 1, got {self.steps_per_call}")
        if self.eval_steps_per_call < 1:
            raise ValueError(f"eval_steps_per_call must be >= 1, got "
                             f"{self.eval_steps_per_call}")
        if self.serve_slots < 1 or self.serve_chunk < 1:
            raise ValueError(
                f"serve_slots and serve_chunk must be >= 1, got "
                f"{self.serve_slots}/{self.serve_chunk}")
        if self.decode_kernel not in ("scan", "pallas"):
            raise ValueError(
                f"decode_kernel must be 'scan' or 'pallas', got "
                f"{self.decode_kernel!r}")
        if self.serve_quantize not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                f"serve_quantize must be 'float32', 'bfloat16' or "
                f"'int8', got {self.serve_quantize!r}")
        if self.bucket_edges:
            edges = self.bucket_edges
            if any(e <= 0 for e in edges):
                raise ValueError(f"bucket_edges must be positive pad "
                                 f"lengths, got {edges}")
            if list(edges) != sorted(set(edges)):
                raise ValueError(f"bucket_edges must be strictly "
                                 f"ascending, got {edges}")
            if edges[-1] > self.max_seq_len:
                raise ValueError(
                    f"bucket_edges {edges} exceed max_seq_len="
                    f"{self.max_seq_len}; a bucket longer than the padded "
                    f"maximum can never be filled")
        if self.serve_prefix_edges:
            edges = self.serve_prefix_edges
            if any(e <= 0 for e in edges):
                raise ValueError(f"serve_prefix_edges must be positive "
                                 f"pad lengths, got {edges}")
            if list(edges) != sorted(set(edges)):
                raise ValueError(f"serve_prefix_edges must be strictly "
                                 f"ascending, got {edges}")
            if edges[-1] > self.max_seq_len:
                raise ValueError(
                    f"serve_prefix_edges {edges} exceed max_seq_len="
                    f"{self.max_seq_len}; a prefix longer than the "
                    f"padded maximum can never be encoded")
        if self.draft_rnn_size < 1:
            raise ValueError(
                f"draft_rnn_size must be >= 1, got {self.draft_rnn_size}")
        if self.draft_num_mixture < 0:
            raise ValueError(
                f"draft_num_mixture must be >= 0 (0 = inherit "
                f"num_mixture), got {self.draft_num_mixture}")
        if self.draft_depth < 1:
            raise ValueError(
                f"draft_depth must be >= 1, got {self.draft_depth}")
        if self.draft_tol < 0:
            raise ValueError(
                f"draft_tol must be >= 0, got {self.draft_tol}")
        if self.bucket_shuffle_window < 1:
            raise ValueError(f"bucket_shuffle_window must be >= 1, got "
                             f"{self.bucket_shuffle_window}")
        if self.bucket_run_len < 0:
            raise ValueError(f"bucket_run_len must be >= 0, got "
                             f"{self.bucket_run_len}")
        if self.ckpt_retries < 0 or self.ckpt_retry_backoff_s < 0:
            raise ValueError(
                f"ckpt_retries and ckpt_retry_backoff_s must be >= 0, "
                f"got {self.ckpt_retries}/{self.ckpt_retry_backoff_s}")

    # -- overrides ---------------------------------------------------------

    def replace(self, **kw: Any) -> "HParams":
        return dataclasses.replace(self, **kw)

    def parse(self, spec: str) -> "HParams":
        """Apply a reference-style ``key=value,key=value`` override string."""
        if not spec:
            return self
        fields = {f.name: f for f in dataclasses.fields(self)}
        out: dict = {}
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(f"bad hparam override {item!r} (want key=value)")
            key, val = item.split("=", 1)
            key = key.strip()
            if key not in fields:
                raise ValueError(f"unknown hparam {key!r}")
            out[key] = _coerce(val.strip(), self.__getattribute__(key))
        return self.replace(**out)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "HParams":
        raw = json.loads(text)
        for k, v in raw.items():
            if isinstance(v, list):
                raw[k] = tuple(v)
        return cls(**raw)


def _coerce(val: str, like: Any) -> Any:
    """Coerce a string override to the type of the current field value."""
    if isinstance(like, bool):  # before int: bool is an int subclass
        low = val.lower()
        if low in ("1", "true", "t", "yes"):
            return True
        if low in ("0", "false", "f", "no"):
            return False
        raise ValueError(f"bad bool {val!r}")
    if isinstance(like, int):
        return int(val)
    if isinstance(like, float):
        return float(val)
    if isinstance(like, tuple):
        items = [s for s in val.split(";") if s]
        if like and isinstance(like[0], int):
            return tuple(int(s) for s in items)
        if not like and all(_is_int(s) for s in items):
            # empty-tuple defaults (bucket_edges=()) carry no element
            # type to copy; all-integer literals coerce to ints
            return tuple(int(s) for s in items)
        return tuple(items)
    return val


def _is_int(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


def get_default_hparams() -> HParams:
    """Reference-parity defaults."""
    return HParams()
