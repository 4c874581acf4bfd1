"""Client helpers of the port.

Only the retry policy (`client/retry.py`, a copy of
hstream_tpu/client/retry.py) is here so far: the flow-control tests
that need no server use it. The SQL shell and the framed-append
producer come with the server (ROADMAP A5b).
"""
