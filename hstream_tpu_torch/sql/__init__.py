"""SQL front end: lexer -> parser -> validate -> refine -> plan, and the
executor factory (the port of hstream_tpu.sql).

lexer.py, parser.py, refine.py, ast.py and plans.py are copies of the
reference's modules; codegen.py lowers a refined statement to a plan as
the reference does (`stream_codegen`, `explain_text`) and builds the
port's executors from a lowered SELECT (`make_executor`, `bind_schema`),
which run on the card unless the caller passes device="cpu".
"""

from hstream_tpu_torch.sql import ast, plans
from hstream_tpu_torch.sql.codegen import (
    Plan,
    bind_schema,
    make_executor,
    stream_codegen,
)
from hstream_tpu_torch.sql.parser import parse
from hstream_tpu_torch.sql.refine import parse_and_refine, refine

__all__ = ["parse", "refine", "parse_and_refine", "stream_codegen", "Plan",
           "plans", "ast", "bind_schema", "make_executor"]
