"""Host-only helpers the engine needs (copies of hstream_tpu.common)."""
