"""Port of ``sketch_rnn_tpu.sample``."""
