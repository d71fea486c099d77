"""The PyTorch port's EngineConfig and Engine refuse what the port does not
have: an op neither package has raises ``NotImplementedError`` naming it, a
wrong input shape raises as in the reference; every config field is
ported.  Few test items per
file (see tests/test_torch_kernels.py for why)."""

import numpy as np
import pytest

from feathercnn_tpu_torch.config import EngineConfig
from feathercnn_tpu_torch.engine import Engine
from feathercnn_tpu_torch.models.builder import GraphBuilder


def _graph():
    b = GraphBuilder("cfg", seed=1)
    x = b.input("data", (1, 9, 9, 3))
    x = b.conv("c1", x, 8, 3, pad=1, relu=True)
    x = b.pool("pool", x, 3, 2)
    return b.finish([b.softmax("prob", b.fc("fc", x, 4))])


def test_engine_checks_input_shapes():
    eng = Engine(_graph(), device="cpu")
    assert eng(np.zeros((2, 9, 9, 3), np.float32)).shape == (2, 4)
    with pytest.raises(ValueError):
        eng(np.zeros((1, 9, 9, 4), np.float32))     # channels may not vary
    with pytest.raises(ValueError):
        eng(np.zeros((9, 9, 3), np.float32))        # nor the rank
    with pytest.raises(KeyError):
        eng.run({"nope": np.zeros((1, 9, 9, 3), np.float32)})
    with pytest.raises(KeyError):
        eng.extract(np.zeros((1, 9, 9, 3), np.float32), ["nope"])


def test_unported_config_fields_raise_naming_them():
    """Every config field is ported: ``compilation_cache_dir`` names the
    directory the kernels and the native runtime build into (no ``nvcc``
    here: the path, not the build); ``sharding`` takes a ShardingConfig
    only."""
    import tempfile
    from pathlib import Path

    from feathercnn_tpu_torch.kernels import build
    from feathercnn_tpu_torch.utils import cache

    with tempfile.TemporaryDirectory() as tmp:
        try:
            eng = Engine(_graph(), EngineConfig(compilation_cache_dir=tmp),
                         device="cpu")
            assert eng(np.zeros((1, 9, 9, 3), np.float32)).shape == (1, 4)
            assert build.library_dir().parent == Path(tmp).resolve()
        finally:
            cache._root = None
    assert build.library_dir().parent != Path(tmp).resolve()
    with pytest.raises(TypeError, match="sharding"):
        Engine(_graph(), EngineConfig(sharding=object()), device="cpu")


def test_unported_op_raises_naming_it():
    """An op neither package has (every op of the reference is lowered)."""
    g = _graph()
    g.nodes[-1].op = "NoSuchOp"
    with pytest.raises(NotImplementedError, match="NoSuchOp"):
        Engine(g, device="cpu", optimize_graph=False)


def test_psroi_fuse_ave_runs_the_pass():
    """``psroi_fuse_ave`` runs ``passes.fuse_psroi_ave``, as in the
    reference: R-FCN's PSROIPooling takes in its vote's global AVE pool
    (``fuse_ave``) and the pool's output name; without the flag both
    nodes stay."""
    from feathercnn_tpu_torch.models import rfcn_resnet101
    g = rfcn_resnet101(size=(64, 64), post_nms_top_n=8)
    ops = lambda eng: {n.name: (n.op, n.attrs.get("fuse_ave"))
                       for n in eng.graph.nodes
                       if n.op in ("PSROIPooling", "Pooling")
                       and "rois" in n.name}
    plain = ops(Engine(g, device="cpu"))
    fused = ops(Engine(g, EngineConfig(psroi_fuse_ave=True), device="cpu"))
    assert plain == {"psroipooled_cls_rois": ("PSROIPooling", None),
                     "ave_cls_score_rois": ("Pooling", None),
                     "psroipooled_loc_rois": ("PSROIPooling", None),
                     "ave_bbox_pred_rois": ("Pooling", None)}, plain
    assert fused == {"psroipooled_cls_rois": ("PSROIPooling", True),
                     "psroipooled_loc_rois": ("PSROIPooling", True)}, fused


def test_config_json_round_trip_and_backends():
    cfg = EngineConfig(backend="cuda", quant="w8a8", compute_dtype="bfloat16",
                       algo_overrides=(("*", "xla"),),
                       fp_act_layers=("conv1",))
    assert EngineConfig.from_json(cfg.to_json()) == cfg
    # a ShardingConfig goes through JSON as the reference's does: as a dict
    # of its fields, tuples restored
    from feathercnn_tpu.config import EngineConfig as JConfig
    from feathercnn_tpu.parallel import ShardingConfig as JSharding
    from feathercnn_tpu_torch.parallel import ShardingConfig
    sharded = cfg.replace(sharding=ShardingConfig(
        mesh_shape=(2, 4), shard_spatial=True, ring_overlap=True))
    back = EngineConfig.from_json(sharded.to_json())
    assert back == sharded and isinstance(back.sharding, ShardingConfig)
    ref = JConfig.from_json(sharded.to_json())
    assert ref.sharding == JSharding(mesh_shape=(2, 4), shard_spatial=True,
                                     ring_overlap=True)
    assert EngineConfig.from_json(ref.to_json()) == sharded
    with pytest.raises(ValueError, match="backend"):
        EngineConfig(backend="pallas").check_supported()
