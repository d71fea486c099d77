"""Full-int8 (w8a8, bf16 activations) runs of SE-ResNet-50 (Sigmoid and
the int8 Axpy) at full width and size, and of ShuffleNet v1/v2 (full
size) and Inception-v3 (full width at a 139x139 input: its 299x299 costs
~5x the CPU time, and every layer keeps its kernel, stride and padding;
the last module runs at 3x3), through the PyTorch port against the JAX
package on the CPU, one image, with the helpers and engines of
tests/test_torch_zoo_rest_int8.py.

Every int8 edge equals the reference's, node by node and end to end, with
one exception: the outputs of SE-ResNet-50's int8 Axpys may differ by 1
LSB node by node.  The reference's compiled Axpy fuses the Sigmoid that
makes its gate and reads it at another precision than the bf16 edge it
materializes: XLA keeps the excess precision inside a fusion, so the gate
the Axpy reads can be the f32 division before its bf16 rounding, and the
producers' bf16 roundings of the Sigmoid's input can go the same way.  The
port's Sigmoid returns the f32 division (``ops/lowering.py``) and each
Axpy here reads the port's own Sigmoid output on the reference's inputs;
three Axpy output elements of ~5.5M still differ at this seed, each by 1
LSB, printed.  Over 16 gated blocks those steps spread end to end
(printed, not held there); the probabilities are held to top-1 and a
cosine >= 0.999.

Few test items per file: see tests/test_torch_kernels.py.
"""

import torch

from test_torch_zoo_rest import _hold_int8_edges, _two_threads  # noqa: F401
from test_torch_zoo_rest_int8 import _engines, _top1_and_cosine


def test_se_resnet50_int8_axpy():
    """SE-ResNet-50: 16 Sigmoids and int8 Axpys; every int8 edge equals the
    reference's node by node but at Axpy outputs (1 LSB, the module
    docstring says why), top-1 and the prob cosine end to end."""
    jeng, teng, x = _engines("se_resnet50")
    q = teng.graph.meta["quant"]
    axpys = [n.name for n in teng.graph.nodes if n.op == "Axpy"]
    assert len(axpys) == 16
    assert sum(bool(q.get(a, {}).get("axpy_int8")) for a in axpys) >= 12
    n_int8, off, ref, got = _hold_int8_edges(
        "se_resnet50 w8a8", jeng, teng, x, lsb_ops=("Axpy",),
        fused_ops=("Sigmoid",), spread=True)
    assert n_int8 >= 60, n_int8
    assert off <= 1e-4 * sum(ref[n.outputs[0]].size for n in teng.graph.nodes
                             if n.op == "Axpy"), off
    cos = _top1_and_cosine("se_resnet50", teng, ref, got)
    print(f"se_resnet50 w8a8: prob cosine {cos:.6f} end to end")


def test_shufflenets_and_inception_v3():
    """ShuffleNet v1 (grouped 1x1 and depthwise convs as the float grouped
    conv, its baked ``int8_grouped=False``; ShuffleChannel between them;
    the AVE 3x3 s2 shortcut pool), ShuffleNet v2 (Slice, Concat and
    ShuffleChannel, its baked ``shuffle_matmul=True``) and Inception-v3
    (asymmetric 1x7/7x1 and 1x3/3x1 convs, AVE 3x3 s1 pools that
    requantize; at 139x139), at full width: every int8 edge equals the
    reference's.  ShuffleNet v1 has none in either engine (each unit's
    convs but one take float inputs, so its int8 lives inside the two
    ungrouped GEMM layers): its float edges are held node by node."""
    for name, min_int8 in (("shufflenet_v1", 0), ("shufflenet_v2", 20),
                           ("inception_v3", 100)):
        jeng, teng, x = _engines(name, 139 if name == "inception_v3"
                                 else None)
        ops = {n.op for n in teng.graph.nodes}
        if name.startswith("shufflenet"):
            assert "ShuffleChannel" in ops, name
        else:
            asym = [n for n in teng.graph.nodes if n.op == "Convolution"
                    and n.attrs["kernel_h"] != n.attrs["kernel_w"]]
            assert len(asym) >= 20, len(asym)
        n_int8, _, ref, got = _hold_int8_edges(f"{name} w8a8", jeng, teng,
                                               x)
        assert n_int8 >= min_int8, (name, n_int8)
        _top1_and_cosine(name, teng, ref, got)
        assert torch.isfinite(got[teng.graph.outputs[0]].float()).all()
