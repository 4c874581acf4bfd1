"""The SQL layer's plan types and executor factory (the part of
hstream_tpu.sql that the engine needs).

ast.py and plans.py are copies of the reference's dataclasses (the
lowered SelectPlan and the JOIN clause it carries); codegen.py holds
`make_executor` and `bind_schema`, which build a port executor from a
lowered plan. The lexer, the parser, `refine` and the rest of codegen
(SQL text to plan) are not ported yet (ROADMAP A4): a port plan is built
from these dataclasses directly.
"""

from hstream_tpu_torch.sql import ast, plans
from hstream_tpu_torch.sql.codegen import bind_schema, make_executor

__all__ = ["ast", "plans", "bind_schema", "make_executor"]
