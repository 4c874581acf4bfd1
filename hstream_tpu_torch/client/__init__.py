"""Client helpers of the port.

The retry policy (`client/retry.py`) and the framed-append producer
(`client/producer.py`, `ColumnarProducer` and `encode_batch`), copies of
the reference's, are here. The SQL shell (the rest of
hstream_tpu/client/__init__.py and its `__main__`) waits for ROADMAP
A5c.
"""

from hstream_tpu_torch.client.producer import ColumnarProducer  # noqa: F401
