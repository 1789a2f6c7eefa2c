"""MoE routing (``router``) and the expert-parallel dispatch
(``dispatch``). The dispatch phase profiler is not ported yet; see
ROADMAP.md."""
