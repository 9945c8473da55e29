"""The port's model zoo (LeNet, ResNet, Inception-v3, U-Net, Wide & Deep)
against the JAX package's flax models on the same weights, on the CPU.

flax initialises each model from a seed; ``convert.<family>_from_flax``
maps the tree onto the port's module, and numpy inputs from a seed go
through both. Checked per family: the forward in eval and in train mode
(float32 variant within 1e-4 of the reference's largest output), the
default bfloat16 variant (tolerance derived below), one SGD step (loss,
updated parameters, BatchNorm statistics) and the bitwise ``convert``
round trip. The three layer conventions that differ from torch's
defaults are each pinned alone, beside the naive torch layer that gets
them wrong.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from tensorflowonspark_tpu import training as jtraining
from tensorflowonspark_tpu.models import inception as jinception
from tensorflowonspark_tpu.models import lenet as jlenet
from tensorflowonspark_tpu.models import resnet as jresnet
from tensorflowonspark_tpu.models import unet as junet
from tensorflowonspark_tpu.models import widedeep as jwidedeep
from tensorflowonspark_tpu_torch import convert, training
from tensorflowonspark_tpu_torch.models import _layers
from tensorflowonspark_tpu_torch.models import inception, lenet, resnet
from tensorflowonspark_tpu_torch.models import unet, widedeep

#: float32 variant against the reference: max |port - ref| over max
#: |ref|. Both run the same float32 products in other summation orders
#: (~1e-7 relative per layer); 1e-4 leaves room for a few dozen layers.
F32_RTOL = 1e-4
#: bfloat16 variant: each framework rounds every product's inputs and
#: output to bfloat16 (8 significant bits, 2^-9 relative per rounding)
#: but not always at the same points (XLA keeps float32 between fused
#: elementwise ops where torch rounds after each), so a layer's output
#: may differ by a bfloat16 ulp, 2^-8 of its value, and the next layer
#: mixes those differences. Over the <= 6 bfloat16 layers in series of
#: these tiny configs, 6 x 2^-8 ~ 2.3% of the largest output bounds it;
#: 2^-4 (6.25%) leaves a factor ~3 for BatchNorm's renormalisation. A
#: wrong layout or padding moves outputs by O(1), far past it.
BF16_RTOL = 2.0 ** -4
SGD_LR = 0.1


def _np(x):
    if torch.is_tensor(x):
        x = x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flax_init(model, inputs, seed=0):
    v = model.init(jax.random.PRNGKey(seed), *inputs)
    params = v["params"]
    extra = {k: v[k] for k in v if k != "params"}
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, extra)


def _port(tmodel, params, extra):
    tmodel.load_state_dict(convert.tree_from_flax(params, extra))
    return tmodel


def _stats_moved(extra, seed=1):
    """Running statistics away from their 0/1 init, so the eval forward
    reads them."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (a + 0.1 * rng.rand(*a.shape)).astype(np.float32), extra)


def _torch_inputs(inputs):
    return [torch.from_numpy(np.asarray(x)) for x in inputs]


# -- the families --------------------------------------------------------


def _images(b, size, c=3, seed=0):
    return np.random.RandomState(seed).rand(b, size, size, c).astype(
        np.float32)


def _resnet(dtype):
    kw = dict(stage_sizes=[1, 1], width=8, num_classes=5)
    return (jresnet.ResNet(dtype=dtype[0], **kw),
            resnet.ResNet(dtype=dtype[1], **kw))


def _unet(dtype):
    return (junet.UNet(num_classes=3, features=(4, 8), dtype=dtype[0]),
            unet.UNet(3, features=(4, 8), dtype=dtype[1]))


def _lenet(dtype):
    return jlenet.LeNet(dtype=dtype[0]), lenet.LeNet(dtype=dtype[1])


def _widedeep(dtype):
    kw = dict(hash_buckets=11, embed_dim=8, mlp_sizes=(32, 16))
    return (jwidedeep.WideDeep(dtype=dtype[0], **kw),
            widedeep.WideDeep(dtype=dtype[1], **kw))


def _inception(dtype):
    return (jinception.InceptionV3(num_classes=5, dtype=dtype[0],
                                   dropout_rate=0.0),
            inception.InceptionV3(num_classes=5, dtype=dtype[1],
                                  dropout_rate=0.0))


def _wd_inputs(b=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, 13).astype(np.float32), rng.randint(0, 11, (b, 26)))


#: name -> (constructor of the (flax, port) pair, inputs, whether the
#: forward takes train=, label maker, the two losses)
FAMILIES = {
    "lenet": (_lenet, lambda: (_images(4, 28, 1),), False,
              lambda rng, b: {"y": rng.randint(0, 10, (b,))},
              jtraining.softmax_xent, training.softmax_xent),
    "resnet": (_resnet, lambda: (_images(4, 32),), True,
               lambda rng, b: {"y": rng.randint(0, 5, (b,))},
               jtraining.softmax_xent, training.softmax_xent),
    "unet": (_unet, lambda: (_images(4, 16),), True,
             lambda rng, b: {"y": rng.randint(0, 3, (b, 16, 16))},
             junet.segmentation_loss, unet.segmentation_loss),
    "widedeep": (_widedeep, _wd_inputs, False,
                 lambda rng, b: {"label": rng.randint(0, 2, (b,))},
                 jwidedeep.ctr_loss, widedeep.ctr_loss),
    "inception": (_inception, lambda: (_images(2, 75),), True,
                  lambda rng, b: {"y": rng.randint(0, 5, (b,))},
                  jtraining.softmax_xent, training.softmax_xent),
}
F32 = (jnp.float32, torch.float32)
BF16 = (jnp.bfloat16, torch.bfloat16)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_eval_forward_matches_flax(family):
    make, inputs, _, _, _, _ = FAMILIES[family]
    inputs = inputs()
    jm, tm = make(F32)
    params, extra = _flax_init(jm, inputs)
    extra = _stats_moved(extra)
    want = jm.apply(dict(extra, params=params), *inputs)
    tm = _port(tm, params, extra).eval()
    with torch.no_grad():
        got = tm(*_torch_inputs(inputs))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= F32_RTOL


@pytest.mark.parametrize("family", ["resnet", "unet"])
def test_train_forward_and_batch_stats_match_flax(family):
    """Train mode normalises with the batch's statistics and updates the
    running ones (biased variance, flax's momentum)."""
    make, inputs, _, _, _, _ = FAMILIES[family]
    inputs = inputs()
    jm, tm = make(F32)
    params, extra = _flax_init(jm, inputs)
    want, new = jm.apply(dict(extra, params=params), *inputs, train=True,
                         mutable=["batch_stats"])
    tm = _port(tm, params, extra).train()
    with torch.no_grad():
        got = tm(*_torch_inputs(inputs))
    assert _rel(got, want) <= F32_RTOL
    want_sd = convert.tree_from_flax(params, new)
    got_sd = tm.state_dict()
    stats = [k for k in want_sd if k.endswith(("running_mean",
                                               "running_var"))]
    assert stats
    for k in stats:
        assert _rel(got_sd[k], want_sd[k]) <= F32_RTOL, k


#: Inception in train mode: every BatchNorm normalises by its channel's
#: batch standard deviation, and at the sizes a CPU test can afford (8
#: images of 75x75) the last grids are 3x3 and 1x1, so the deep BNs see
#: 8-72 values a channel. Each divides float32 rounding differences by a
#: small deviation, and over ~90 BNs in series they grow from 1e-6 at
#: the stem to ~1e-3 at the head (measured 2.0e-3 at 8 x 75x75, 7e-2 at
#: 2 x 75x75). So the whole model is held at 1e-2 in train mode, and
#: each block alone, on an input with enough values a channel, at
#: F32_RTOL.
INCEPTION_TRAIN_RTOL = 1e-2


def test_inception_train_forward_matches_flax():
    make, _, _, _, _, _ = FAMILIES["inception"]
    inputs = (_images(8, 75),)
    jm, tm = make(F32)
    params, extra = _flax_init(jm, inputs)
    want, new = jm.apply(dict(extra, params=params), *inputs, train=True,
                         mutable=["batch_stats"])
    tm = _port(tm, params, extra).train()
    with torch.no_grad():
        got = tm(*_torch_inputs(inputs))
    assert _rel(got, want) <= INCEPTION_TRAIN_RTOL
    # the stem's statistics: thousands of values a channel
    want_sd = convert.tree_from_flax(params, new)
    for k in ("ConvBN_0.BatchNorm_0.running_mean",
              "ConvBN_0.BatchNorm_0.running_var"):
        assert _rel(tm.state_dict()[k], want_sd[k]) <= F32_RTOL, k


@pytest.mark.parametrize("block", ["InceptionA", "ReductionA", "InceptionB",
                                   "ReductionB", "InceptionC"])
def test_inception_blocks_match_flax_in_train_mode(block):
    c_in = {"InceptionA": 192, "ReductionA": 288, "InceptionB": 768,
            "ReductionB": 768, "InceptionC": 1280}[block]
    args = {"InceptionA": (32,), "InceptionB": (128,)}.get(block, ())
    x = np.random.RandomState(3).randn(4, 9, 9, c_in).astype(np.float32)
    jm = getattr(jinception, block)(*args, dtype=jnp.float32)
    tm = getattr(inception, block)(c_in, *args, dtype=torch.float32)
    params, extra = _flax_init(jm, (x,))
    want, new = jm.apply(dict(extra, params=params), x, True,
                         mutable=["batch_stats"])
    tm = _port(tm, params, extra).train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _rel(got, want) <= F32_RTOL
    want_sd = convert.tree_from_flax(params, new)
    for k, v in tm.state_dict().items():
        assert _rel(v, want_sd[k]) <= F32_RTOL, k


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_forward_matches_flax(family):
    make, inputs, _, _, _, _ = FAMILIES[family]
    inputs = inputs()
    jm, tm = make(BF16)
    params, extra = _flax_init(jm, inputs)
    extra = _stats_moved(extra)
    want = jm.apply(dict(extra, params=params), *inputs)
    tm = _port(tm, params, extra).eval()
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    with torch.no_grad():
        got = tm(*_torch_inputs(inputs))
    assert got.dtype == torch.float32  # float32 heads, as the reference
    assert _rel(got, want) <= BF16_RTOL


def _jax_sgd_step(jm, params, extra, inputs, batch, loss_fn, train):
    kw = {"train": True} if train else {}

    def loss_of(p):
        variables = dict(extra, params=p)
        if extra:
            out, new = jm.apply(variables, *inputs, mutable=list(extra),
                                **kw)
        else:
            out, new = jm.apply(variables, *inputs, **kw), {}
        return loss_fn(out, batch), new

    (loss, new), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(params)
    tx = optax.sgd(SGD_LR)
    upd, _ = tx.update(grads, tx.init(params), params)
    return (float(loss), jax.tree.map(np.asarray,
                                      optax.apply_updates(params, upd)),
            jax.tree.map(np.asarray, new))


#: one SGD step: the loss as F32_RTOL; each parameter's UPDATE (new -
#: old, lr x gradient) within 1e-3 of its largest element, floored at
#: 1e-3 of the largest update of the model: a gradient sums over the
#: batch and pixels in another order, and train-mode BatchNorm divides
#: by batch deviations (see INCEPTION_TRAIN_RTOL), so gradients carry
#: ~1e-5..1e-4 relative noise; a transposed kernel, a shifted padding or
#: an unbiased variance moves updates by O(1) of themselves
STEP_UPDATE_RTOL = 1e-3


@pytest.mark.parametrize("family", ["lenet", "resnet", "unet", "widedeep"])
def test_one_sgd_step_matches_flax(family):
    make, inputs, train, labels, jloss, tloss = FAMILIES[family]
    inputs = inputs()
    jm, tm = make(F32)
    params, extra = _flax_init(jm, inputs)
    b = inputs[0].shape[0]
    batch = labels(np.random.RandomState(7), b)
    keys = ("dense", "cat") if family == "widedeep" else ("x",)
    batch.update(zip(keys, inputs))
    want_loss, want_p, want_new = _jax_sgd_step(
        jm, params, extra, inputs, batch, jloss, train)

    tm = _port(tm, params, extra)
    trainer = training.Trainer(
        tm, lambda p: torch.optim.SGD(p, lr=SGD_LR), loss_fn=tloss,
        input_keys=keys, device="cpu")
    state = trainer.init()
    state, metrics = trainer.step(state, batch)
    assert abs(float(metrics["loss"]) - want_loss) <= F32_RTOL * abs(
        want_loss)

    got_p, got_extra = convert.tree_to_flax(tm.state_dict())
    old = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    want_leaves = dict(jax.tree_util.tree_flatten_with_path(want_p)[0])
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(got_p)[0])
    assert set(got_leaves) == set(want_leaves)
    updates = {k: want_leaves[k] - old[k] for k in old}
    top = max(np.abs(u).max() for u in updates.values())
    assert top > 0
    for k, upd in updates.items():
        got_upd = got_leaves[k] - old[k]
        scale = max(np.abs(upd).max(), 1e-3 * top)
        assert np.abs(got_upd - upd).max() <= STEP_UPDATE_RTOL * scale, k
    if train:
        want_sd = convert.tree_from_flax(want_p, want_new)
        got_sd = tm.state_dict()
        for k in want_sd:
            if k.endswith(("running_mean", "running_var")):
                assert _rel(got_sd[k], want_sd[k]) <= F32_RTOL, k


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_convert_round_trip_is_bitwise(family):
    make, inputs, _, _, _, _ = FAMILIES[family]
    jm, tm = make(F32)
    params, extra = _flax_init(jm, inputs())
    sd = convert.tree_from_flax(params, extra)
    tm.load_state_dict(sd)  # strict: every name and shape lines up
    to_flax = getattr(convert, family + "_to_flax")
    back, back_extra = to_flax(tm.state_dict())
    for (path, a), (path2, b) in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert path == path2
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    assert jax.tree_util.tree_structure(extra) == \
        jax.tree_util.tree_structure(back_extra)
    for a, b in zip(jax.tree.leaves(extra), jax.tree.leaves(back_extra)):
        assert np.array_equal(a, b)
    from_flax = getattr(convert, family + "_from_flax")
    again = from_flax(back, back_extra)
    assert all(torch.equal(again[k], v) for k, v in sd.items())


def test_resnet50_and_cifar_variants_have_the_references_widths():
    want = jax.eval_shape(lambda: jresnet.ResNet50Cifar().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    n_want = sum(int(np.prod(l.shape)) for l in jax.tree.leaves(
        want["params"]))
    tm = resnet.ResNet50Cifar(device="meta")
    assert sum(p.numel() for p in tm.parameters()) == n_want
    assert tm.num_classes == 10
    big = resnet.ResNet50(device="meta")
    assert sum(p.numel() for p in big.parameters()) == 25557032
    stem = resnet.ResNet(stage_sizes=[1], width=4, cifar_stem=True)
    assert stem.conv_init.kernel_size == (3, 3)


# -- the three layer conventions, each alone -----------------------------


@pytest.mark.parametrize("size", [7, 8, 9, 16])
@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (1, 2), (7, 2)])
def test_conv2d_same_matches_flax_and_the_naive_pad_does_not(size, kernel,
                                                             stride):
    import flax.linen as nn

    rng = np.random.RandomState(size * 10 + kernel)
    x = rng.randn(2, size, size, 3).astype(np.float32)
    conv = nn.Conv(4, (kernel, kernel), strides=(stride, stride),
                   padding="SAME", use_bias=False)
    v = conv.init(jax.random.PRNGKey(0), x)
    want = np.asarray(conv.apply(v, x))
    w = torch.from_numpy(np.asarray(v["params"]["kernel"]).transpose(
        3, 2, 0, 1).copy())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = _layers.conv2d_same(xt, w, stride=stride).permute(0, 2, 3, 1)
    assert _rel(got, want) <= 1e-5
    naive = F.conv2d(xt, w, stride=stride, padding=kernel // 2).permute(
        0, 2, 3, 1)
    lo, hi = _layers.same_pads(size, kernel, stride)
    if lo != hi:  # asymmetric SAME: torch's symmetric pad shifts a pixel
        assert naive.shape != want.shape or _rel(naive, want) > 0.1


def test_conv_transpose_matches_flax_and_the_unflipped_kernel_does_not():
    import flax.linen as nn

    x = np.random.RandomState(0).randn(2, 5, 6, 3).astype(np.float32)
    layer = nn.ConvTranspose(4, (2, 2), strides=(2, 2), use_bias=False)
    v = layer.init(jax.random.PRNGKey(0), x)
    want = np.asarray(layer.apply(v, x))
    sd = convert.unet_from_flax({"ConvTranspose_0": v["params"]})
    w = sd["ConvTranspose_0.weight"]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = _layers.conv_transpose(xt, w, 2).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 10, 12, 4)
    assert _rel(got, want) <= 1e-6
    raw = torch.from_numpy(np.asarray(v["params"]["kernel"]).transpose(
        2, 3, 0, 1).copy())  # [in, out, kh, kw], not flipped
    naive = F.conv_transpose2d(xt, raw, stride=2).permute(0, 2, 3, 1)
    assert _rel(naive, want) > 0.1


def test_batchnorm_running_update_matches_flax_and_torch_default_does_not():
    import flax.linen as nn

    x = np.random.RandomState(0).randn(4, 2, 2, 3).astype(np.float32) * 2
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                      epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), x)
    want, new = bn.apply(v, x, mutable=["batch_stats"])
    layer = _layers.BatchNorm(3, momentum=0.9, epsilon=1e-5).train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = layer(xt).permute(0, 2, 3, 1)
    assert _rel(got, want) <= 1e-5
    want_var = np.asarray(new["batch_stats"]["var"])
    want_mean = np.asarray(new["batch_stats"]["mean"])
    assert _rel(layer.running_var, want_var) <= 1e-6
    assert _rel(layer.running_mean, want_mean) <= 1e-6
    # torch's BatchNorm2d with the "same" momentum (0.1 = 1 - 0.9)
    # updates with the unbiased variance: n/(n-1) = 16/15 of the batch's
    naive = torch.nn.BatchNorm2d(3, momentum=0.1, eps=1e-5).train()
    naive(xt)
    assert _rel(naive.running_var, want_var) > 1e-3
    # and flax's momentum passed to torch as it is barely moves the stats
    naive = torch.nn.BatchNorm2d(3, momentum=0.9, eps=1e-5).train()
    naive(xt)
    assert _rel(naive.running_mean, want_mean) > 1


def test_lenet_flattens_in_hwc_order():
    """Dense_0's kernel rows are in the reference's H, W, C order: a
    channel-major flatten of the same weights gives other logits."""
    jm, tm = _lenet(F32)
    x = _images(2, 28, 1)
    params, extra = _flax_init(jm, (x,))
    want = jm.apply({"params": params}, x)
    tm = _port(tm, params, extra).eval()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        assert _rel(tm(xt), want) <= F32_RTOL
        h = _layers.nhwc_to_nchw(xt)
        h = F.max_pool2d(F.relu(tm.Conv_0(h)), 2, 2)
        h = F.max_pool2d(F.relu(tm.Conv_1(h)), 2, 2)
        chw = tm.Dense_1(F.relu(tm.Dense_0(h.reshape(2, -1))))
    assert _rel(chw, want) > 1e-2


# -- Wide & Deep's int8 tables and hashing -------------------------------


def test_quantize_embeddings_is_bitwise_the_references():
    jm, tm = _widedeep(F32)
    inputs = _wd_inputs(32)
    params, _ = _flax_init(jm, inputs)
    table = np.array(params["deep_embeddings"]["embedding"])
    table[3] = 0.0  # an all-zero row
    params["deep_embeddings"]["embedding"] = table
    slim_j, quant_j = jwidedeep.quantize_embeddings(params)
    sd = convert.widedeep_from_flax(params)
    slim, quant = widedeep.quantize_embeddings(sd)
    assert "deep_embeddings.weight" not in slim
    assert "wide_embeddings.weight" in slim
    table = quant["deep_embeddings.table"]
    scale = quant["deep_embeddings.scale"]
    assert table.dtype == torch.int8 and scale.dtype == torch.float32
    assert np.array_equal(table.numpy(),
                          np.asarray(quant_j["deep_embeddings"]["table"]))
    assert np.array_equal(scale.numpy(),
                          np.asarray(quant_j["deep_embeddings"]["scale"]))
    # the int8 model: buffers (no optimizer sees them), logits as the
    # reference's test holds them against the float model
    qm = widedeep.WideDeep(hash_buckets=11, embed_dim=8, mlp_sizes=(32, 16),
                           dtype=torch.float32, quantized=True)
    qm.load_state_dict(dict(slim, **quant))
    names = {n for n, _ in qm.named_parameters()}
    assert not any(n.startswith("deep_embeddings") for n in names)
    assert {"deep_embeddings.table", "deep_embeddings.scale"} <= {
        n for n, _ in qm.named_buffers()}
    tm = _port(tm, params, {}).eval()
    xs = _torch_inputs(inputs)
    with torch.no_grad():
        ref = tm(*xs).numpy()
        got = qm.eval()(*xs).numpy()
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05)
    assert np.corrcoef(got, ref)[0, 1] > 0.999
    jq = jwidedeep.WideDeep(hash_buckets=11, embed_dim=8,
                            mlp_sizes=(32, 16), dtype=jnp.float32,
                            quantized=True)
    want = jq.apply({"params": slim_j, "quant": quant_j}, *inputs)
    assert _rel(got, want) <= F32_RTOL
    # the convert bridge carries the quant collection both ways
    back_p, back_extra = convert.widedeep_to_flax(qm.state_dict())
    assert np.array_equal(back_extra["quant"]["deep_embeddings"]["table"],
                          np.asarray(quant_j["deep_embeddings"]["table"]))


def test_hash_categorical_is_bitwise_the_references():
    values = ["x", "y", "x", 17, "05db9164", "", 3.5] + [
        "%08x" % i for i in range(200)]
    for buckets in (1000, 100_000):
        got = widedeep.hash_categorical(values, buckets)
        want = jwidedeep.hash_categorical(values, buckets)
        assert got.dtype == want.dtype and np.array_equal(got, want)


# -- losses and metrics ------------------------------------------------


def test_losses_and_mean_iou_match_the_references():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 4, 4, 3).astype(np.float32)
    y = rng.randint(0, 3, (2, 4, 4))
    want = float(junet.segmentation_loss(logits, {"y": y}))
    got = float(unet.segmentation_loss(torch.from_numpy(logits),
                                       {"y": torch.from_numpy(y)}))
    assert abs(got - want) <= 1e-6 * abs(want)
    perfect = np.eye(3, dtype=np.float32)[y]
    for lg in (logits, perfect):
        want = float(junet.mean_iou(lg, y, 3))
        got = float(unet.mean_iou(torch.from_numpy(lg), y, 3))
        assert abs(got - want) <= 1e-6
    assert float(unet.mean_iou(torch.from_numpy(perfect), y, 3)) == 1.0
    z = rng.randn(16).astype(np.float32)
    lab = rng.randint(0, 2, (16,))
    want = float(jwidedeep.ctr_loss(z, {"label": lab}))
    got = float(widedeep.ctr_loss(torch.from_numpy(z),
                                  {"label": torch.from_numpy(lab)}))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_init_weights_is_seeded_and_flax_shaped():
    m = resnet.ResNet(stage_sizes=[1], width=4, num_classes=3)
    a = m.init_weights(torch.Generator().manual_seed(0)).state_dict()
    a = {k: v.clone() for k, v in a.items()}
    b = m.init_weights(torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # zero-init last BN scale, unit others, zero biases
    assert torch.count_nonzero(b["BottleneckBlock_0.BatchNorm_2.weight"]) \
        == 0
    assert torch.all(b["bn_init.weight"] == 1)
    assert torch.all(b["Dense_0.bias"] == 0)
    w = b["BottleneckBlock_0.Conv_1.weight"]       # fan_in 3*3*4
    assert abs(float(w.std()) - 36 ** -0.5) < 0.1 * 36 ** -0.5
