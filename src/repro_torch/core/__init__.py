"""HarMoEny MoE block: routing, scheduling, dispatch, expert FFN."""
