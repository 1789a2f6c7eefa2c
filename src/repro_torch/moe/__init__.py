"""MoE routing. The expert-parallel dispatch path (packers, replica choice,
EP rounds) is not ported yet; see ROADMAP.md."""
