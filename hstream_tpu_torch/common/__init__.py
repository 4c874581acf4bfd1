"""Host-only helpers (copies of hstream_tpu.common); re-exports what the
reference's package does."""

from hstream_tpu_torch.common.idgen import gen_unique
from hstream_tpu_torch.common.records import (
    build_record,
    parse_record,
    payload_to_struct,
    record_to_dict,
    struct_to_dict,
    dict_to_struct,
    flatten_json,
)

__all__ = [
    "gen_unique",
    "build_record",
    "parse_record",
    "payload_to_struct",
    "record_to_dict",
    "struct_to_dict",
    "dict_to_struct",
    "flatten_json",
]
