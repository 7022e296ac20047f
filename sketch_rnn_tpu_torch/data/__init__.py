"""Port of ``sketch_rnn_tpu.data``."""
