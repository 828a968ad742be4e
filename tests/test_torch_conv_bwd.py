"""The folded convolutions' hand-written backward (ml/conv_kernel.py) on the
CPU: its plain version, which the CUDA kernels repeat, against float64
autograd of ``F.conv2d`` at every conv shape of PilotNet and Rambo; the
kernels' mapping at the benchmark cells' shapes; the route a folded
block's conv takes (``block_conv``) and its tally."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pilotguru_tpu_torch.ml import conv_kernel as ck

# Each conv of the two foldable nets: (input channels a net, output channels
# a net, kernel, stride, input height, width, shared). A trunk's first conv
# reads the image shared by every net; the later ones are grouped.
PILOTNET = {"conv1": (3, 24, 5, 2, 66, 200, True), "conv2": (24, 36, 5, 2, 31, 98, False),
            "conv3": (36, 48, 5, 2, 14, 47, False), "conv4": (48, 64, 3, 1, 5, 22, False),
            "conv5": (64, 64, 3, 1, 3, 20, False)}
RAMBO = {"comma1": (3, 16, 8, 4, 100, 300, True), "comma2": (16, 32, 5, 2, 24, 74, False),
         "comma3": (32, 64, 5, 2, 10, 35, False), "nv1": (3, 24, 5, 2, 100, 300, True),
         "nv2": (24, 36, 5, 2, 48, 148, False), "nv3": (36, 48, 5, 2, 22, 72, False),
         "nv4": (48, 64, 3, 2, 9, 34, False), "nv5": (64, 64, 3, 2, 4, 16, False),
         "four1": (3, 36, 5, 2, 100, 300, True), "four2": (36, 48, 5, 2, 48, 148, False),
         "four3": (48, 64, 3, 2, 22, 72, False), "four4": (64, 64, 3, 2, 10, 35, False)}
# (layer, nets): every layer of both nets at x3; PilotNet's also at x12 (the
# search cell) and x1 (groups 1 throughout).
CASES = ([(f"pilotnet.{k}", n) for k in PILOTNET for n in (1, 3, 12)]
         + [(f"rambo.{k}", 3) for k in RAMBO])


def _layer(name):
    net, layer = name.split(".")
    return (PILOTNET if net == "pilotnet" else RAMBO)[layer]


def _case(name, nets, batch, dtype=torch.float64, seed=0):
    """(x, kernel, bias, dy, stride, groups) from a seed: x channels-last
    as the folded path holds it."""
    cin, cout, k, stride, h, w, shared = _layer(name)
    groups = 1 if shared else nets
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(batch, cin * groups, h, w)), dtype=dtype)
    kernel = torch.as_tensor(rng.normal(size=(nets, k, k, cin, cout)) / k / np.sqrt(cin),
                             dtype=dtype)
    bias = torch.as_tensor(rng.normal(size=(nets, cout)), dtype=dtype)
    ho, wo = (h - k) // stride + 1, (w - k) // stride + 1
    dy = torch.as_tensor(rng.normal(size=(batch, nets * cout, ho, wo)), dtype=dtype)
    return (x.contiguous(memory_format=torch.channels_last), kernel, bias,
            dy.contiguous(memory_format=torch.channels_last), stride, groups)


@pytest.mark.parametrize("name,nets", CASES)
def test_plain_version_matches_float64_autograd(name, nets):
    """dgrad (where the input is a net's own channels) and wgrad's kernel and
    bias gradients against autograd of the folded ``F.conv2d``, in float64,
    with the partitions of the pixels the kernels take at this shape."""
    x, kernel, bias, dy, stride, groups = _case(name, nets, batch=4)
    xr, kr, br = (t.clone().requires_grad_(True) for t in (x, kernel, bias))
    y = F.conv2d(xr, ck.fold_conv_kernel(kr), br.reshape(-1), stride=stride, groups=groups)
    assert y.shape == dy.shape
    y.backward(dy)
    dw, db = ck.conv_wgrad(x, dy, kernel.shape, stride, groups)
    torch.testing.assert_close(dw, kr.grad, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(db, br.grad, rtol=1e-10, atol=1e-10)
    if groups == nets and x.shape[1] // groups % 4 == 0:
        dx = ck.conv_dgrad(dy, kernel, x.shape, stride, groups)
        assert dx.is_contiguous(memory_format=torch.channels_last)
        torch.testing.assert_close(dx, xr.grad, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("splits", [1, 2, 7])
def test_wgrad_partitions_add_to_one_sum(splits):
    """The partitions cover the pixels once, in order, each a whole number
    of 16-pixel steps but the last; the plain wgrad's result does not depend
    on their number beyond rounding."""
    x, kernel, bias, dy, stride, groups = _case("rambo.nv3", 3, batch=2)
    pixels = dy.shape[0] * dy.shape[2] * dy.shape[3]
    parts = ck.partitions(pixels, splits)
    assert parts[0][0] == 0 and parts[-1][1] == pixels
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    assert all((end - begin) % 16 == 0 for begin, end in parts[:-1])
    one = ck.conv_wgrad_plain(x, dy, groups, 5, stride, 48, 1)
    many = ck.conv_wgrad_plain(x, dy, groups, 5, stride, 48, splits)
    for a, b in zip(one, many):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def _cell_layers():
    """(layer, nets) of the benchmark cells: PilotNet x3 and x12, Rambo x3."""
    return ([(f"pilotnet.{k}", n) for k in PILOTNET for n in (3, 12)]
            + [(f"rambo.{k}", 3) for k in RAMBO])


@pytest.mark.parametrize("name,nets", _cell_layers())
def test_kernel_mapping_at_the_cells_shapes(name, nets):
    """At batch 1,024: wgrad's blocks cover every column and channel once, at
    most 256 threads a block and one wave of as many blocks an SM as 512
    threads hold, each partition at least 32 steps; x's loads fit one column
    a thread. dgrad's tile covers the input channels, its steps divide the
    output channels, and its rectangles hold at most 8 pixels a thread and
    cover the largest phase's grid, at least three quarters filled but in
    the smallest layers."""
    cin, cout, k, stride, h, w, shared = _layer(name)
    groups = 1 if shared else nets
    m = cout * nets // groups
    ho, wo = (h - k) // stride + 1, (w - k) // stride + 1
    pixels = 1024 * ho * wo
    tile, long_threads, n_tiles, m_tiles, splits = ck.wgrad_mapping(pixels, groups, cin, m, k)
    cols = k * k * cin + 1
    threads = tile // 4 * long_threads
    assert tile % 4 == 0 and tile <= 64 and threads <= 256
    assert (m_tiles - 1) * tile < m <= m_tiles * tile
    assert (n_tiles - 1) * 8 * long_threads < cols <= n_tiles * 8 * long_threads
    assert 8 * long_threads // (4 if cin % 4 == 0 else 1) <= threads
    assert splits == 1 or n_tiles * m_tiles * groups * splits <= 132 * (512 // threads)
    assert pixels // splits >= 512
    if not shared:
        tile, long_threads, chunk, rows, cols = ck.dgrad_mapping(cin, cout, h, w, k, stride)
        assert tile >= cin and tile % 4 == 0 and tile // 4 * long_threads <= 256
        assert cout % chunk == 0 and chunk in (12, 16)
        assert (k, stride) in ck.DGRAD_SHAPES
        hq, wq = -(-h // stride), -(-w // stride)
        assert 1 <= rows <= hq and 1 <= cols <= wq and rows * cols <= 8 * long_threads
        blocks = -(-hq // rows) * -(-wq // cols)
        assert hq * wq >= 0.75 * blocks * 8 * long_threads or hq * wq < 300
    assert (k, stride) in ck.WGRAD_SHAPES


@pytest.mark.parametrize("device,dtype,train,want", [
    ("cpu", torch.float32, True, False), ("cuda", torch.bfloat16, True, False),
    ("cuda", torch.float32, False, False), ("cuda", torch.float32, True, True)])
def test_the_route_follows_device_dtype_and_mode(device, dtype, train, want):
    """Only a train-mode CUDA float32 activation takes the hand-written
    backward; a CPU float32 one, a CUDA bfloat16 one and eval take
    ``F.conv2d``."""
    x = types.SimpleNamespace(is_cuda=device == "cuda", dtype=dtype)
    assert ck.hand_backward(x, train) is want


def _step(net, nets, batch, hand, monkeypatch):
    """One folded float32 SGD train step on the CPU; with ``hand`` the convs
    take the Function (its plain backward on the CPU), as CUDA float32
    tensors would. Returns (losses, gradients by leaf, tallies)."""
    from pilotguru_tpu_torch.ml import augmentation, models, training
    from pilotguru_tpu_torch.utils import profiling

    monkeypatch.setattr(ck, "hand_backward", lambda x, train: hand and train)
    height, width = (66, 200) if net == "nvidia" else (100, 300)
    options = {"net_name": net, "net_head_dims": 10, "label_dimensions": 1,
               "dropout_prob": 0.0, "compute_dtype": "float32"}
    model = models.make_network(options, [{"input_name": "forward_axis", "input_dims": 3}],
                                (height, width, 3))
    tx = training.make_optimizer("sgd", 1e-3)
    state = training.init_ensemble(model, {}, nets, tx, seed=1)
    settings = training.TrainSettings(epochs=1, batch_size=batch,
                                      augment=augmentation.AugmentSettings(target_width=width))
    rng = np.random.default_rng(4)
    inputs = {"frame_img": torch.as_tensor(rng.integers(0, 256, (batch, height, width, 3),
                                                        dtype=np.uint8)),
              "forward_axis": torch.as_tensor(rng.normal(size=(batch, 3)).astype(np.float32))}
    labels = torch.as_tensor(rng.normal(0, 0.3, (batch, 1)).astype(np.float32))
    timer = profiling.StageTimer("step")
    with profiling.recording(timer):
        new, losses, _ = training.make_train_step(model, tx, settings)(
            state, inputs, labels, torch.ones((nets, batch)), torch.ones(nets, dtype=torch.bool),
            torch.Generator())

    def leaves(tree, prefix=""):
        return {k2: v2 for k, t in tree.items()
                for k2, v2 in (leaves(t, f"{prefix}{k}/") if isinstance(t, dict)
                               else {prefix + k: t}).items()}

    before, after = leaves(state.params), leaves(new.params)
    return losses, {k: (before[k] - after[k]) / 1e-3 for k in before}, dict(timer.tallies)


@pytest.mark.parametrize("net,nets,convs", [("nvidia", 3, 5), ("rambo", 3, 12)])
def test_a_train_step_through_the_function_tallies_each_conv(net, nets, convs, monkeypatch):
    """A folded train step whose convs take the Function tallies
    ``folded.conv_bwd_hand`` once a conv (5 for PilotNet, 12 for Rambo), and
    its gradients (SGD's step over the learning rate) equal the
    ``F.conv2d`` path's within float32 rounding of each leaf's norm (of the
    kernel's, for a bias just before batch norm: its gradient is rounding
    noise about 0). The default CPU route tallies nothing."""
    losses, grads, tallies = _step(net, nets, 4, True, monkeypatch)
    assert tallies.get("folded.conv_bwd_hand") == convs
    want_losses, want, plain_tallies = _step(net, nets, 4, False, monkeypatch)
    assert "folded.conv_bwd_hand" not in plain_tallies
    torch.testing.assert_close(losses, want_losses, rtol=0, atol=0)
    for key, g in want.items():
        before_bn = key.endswith("Conv_0/bias") or (key.startswith("FcBlock_")
                                                   and key.endswith("Dense_0/bias"))
        scale = float(want[key.replace("bias", "kernel")].norm() if before_bn else g.norm())
        assert float((grads[key] - g).norm()) <= 1e-5 * scale, key
