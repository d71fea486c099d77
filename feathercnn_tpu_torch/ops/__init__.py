from .lowering import LoweringCtx, lower_node, register_lowering

__all__ = ["LoweringCtx", "lower_node", "register_lowering"]
