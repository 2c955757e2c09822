"""The port's ResNet-152 feature extractor against the JAX package's.

One JAX param tree (batch-norm scale and bias made non-trivial) is carried
into the port by `interop`; the same numpy inputs run through both. The
float32 tolerance is the port's atol = rtol = 5e-5 (ROADMAP): the two sum
the convolutions in other orders, about 1e-6 of the largest feature at
blocks (1, 1, 1, 1) and 64 x 64 inputs. The torchvision-named oracle is
tests/test_resnet.py's, rebuilt here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as F

from fancyrec_tpu.models import resnet as jresnet
from fancyrec_tpu_torch import interop
from fancyrec_tpu_torch.models import resnet

BLOCKS = (1, 1, 1, 1)
TOL = dict(atol=5e-5, rtol=5e-5)
BF16_ULP = 2.0 ** -7   # bf16 keeps 8 significant bits: one ulp is 2^-7..2^-8


def _jax_tree(seed=0, blocks=BLOCKS, hw=64):
    x = jnp.zeros((1, hw, hw, 3), jnp.float32)
    params = jresnet.ResNetFeatures(blocks=blocks, dtype=jnp.float32).init(
        jax.random.PRNGKey(seed), x)["params"]
    rng = np.random.RandomState(seed + 1)

    def bump(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = bump(v)
            elif k == "scale":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "bias":
                out[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return bump(jax.device_get(params))


def _jax_features(params, x_nhwc, dtype=jnp.float32, stem_s2d=False,
                  blocks=BLOCKS):
    model = jresnet.ResNetFeatures(blocks=blocks, dtype=dtype,
                                   stem_s2d=stem_s2d)
    return np.asarray(model.apply({"params": params}, jnp.asarray(x_nhwc)))


def _port_features(params, x_nhwc, dtype=torch.float32, stem_s2d=False):
    model = resnet.load_resnet(params, dtype, stem_s2d)
    with torch.no_grad():
        x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous()
        return model(x).numpy()


@pytest.fixture(scope="module")
def tree():
    return _jax_tree()


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)


@pytest.mark.parametrize("stem_s2d", [False, True], ids=["plain", "s2d"])
def test_resnet_forward_matches_jax(tree, images, stem_s2d):
    want = _jax_features(tree, images, stem_s2d=stem_s2d)
    got = _port_features(tree, images, stem_s2d=stem_s2d)
    assert got.shape == (2, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_space_to_depth_stem_equals_the_plain_stem(tree, images):
    np.testing.assert_allclose(_port_features(tree, images, stem_s2d=True),
                               _port_features(tree, images), **TOL)


# tests/test_resnet.py's oracle: torchvision's v1.5 ResNet and its names
class TorchBottleneck(tnn.Module):
    def __init__(self, inplanes, width, stride):
        super().__init__()
        out = width * 4
        self.conv1 = tnn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(width)
        self.conv2 = tnn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(width)
        self.conv3 = tnn.Conv2d(width, out, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(out)
        self.downsample = tnn.Sequential(
            tnn.Conv2d(inplanes, out, 1, stride, bias=False),
            tnn.BatchNorm2d(out))

    def forward(self, x):
        idt = self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + idt)


class TorchResNetOracle(tnn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        inplanes, width = 64, 64
        for stage, n in enumerate(BLOCKS):
            blocks = []
            for b in range(n):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(TorchBottleneck(inplanes, width, stride))
                inplanes = width * 4
            setattr(self, "layer%d" % (stage + 1), tnn.Sequential(*blocks))
            width *= 2

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for s in range(4):
            x = getattr(self, "layer%d" % (s + 1))(x)
        return x.mean(dim=(2, 3))


def test_torchvision_import_matches_jax(images):
    torch.manual_seed(0)
    oracle = TorchResNetOracle()
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for m in oracle.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.copy_(torch.tensor(
                    rng.randn(m.num_features), dtype=torch.float32))
                m.running_var.copy_(torch.tensor(
                    np.abs(rng.randn(m.num_features)) + 0.5,
                    dtype=torch.float32))
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.5, 0.5)
    oracle.eval()
    sd = oracle.state_dict()
    ours = resnet.params_from_torch(sd, BLOCKS)
    theirs = jresnet.ResNetFeatures.params_from_torch(sd, BLOCKS)
    flat_o, flat_t = interop._flatten(ours), interop._flatten(theirs)
    assert flat_o.keys() == flat_t.keys()
    for k in flat_o:
        np.testing.assert_array_equal(flat_o[k], flat_t[k], err_msg=k)
    got = _port_features(ours, images)
    np.testing.assert_allclose(got, _jax_features(theirs, images), **TOL)
    with torch.no_grad():
        want = oracle(torch.from_numpy(images).permute(0, 3, 1, 2)).numpy()
    # the oracle normalizes with the running stats unfolded: float32
    # rounding of scale = gamma / sqrt(var + eps) against the folded form
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_full_depth_state_dict_matches_the_jax_tree():
    shapes = jax.eval_shape(jresnet.init_random_params)
    want = {}
    for path, leaf in interop._flatten(
            jax.tree_util.tree_map(
                lambda s: np.broadcast_to(np.float32(0), s.shape),
                shapes)).items():
        key, arr = interop._param_entry(path, leaf)
        want[key] = tuple(arr.shape)
    with torch.device("meta"):
        model = resnet.ResNetFeatures(resnet.RESNET152_BLOCKS)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    # the stem's 3, 9 a bottleneck and 3 more for each stage's downsample
    assert len(got) == 3 + 50 * 9 + 4 * 3
    state = resnet.init_random_params(seed=0)
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    assert resnet.blocks_of(state) == resnet.RESNET152_BLOCKS
    assert resnet.blocks_of(shapes) == resnet.RESNET152_BLOCKS
    # LeCun normal, truncated at 2 sigma: std sqrt(1 / fan_in)
    w = state["layer3_5.conv2.weight"]
    assert abs(w.std().item() * (256 * 9) ** 0.5 - 1.0) < 0.02
    assert w.abs().max().item() <= 2 / 0.87962566 / (256 * 9) ** 0.5 + 1e-6
    assert torch.equal(state["bn1.weight"], torch.ones(64))
    assert torch.equal(state["layer1_0.down_bn.bias"], torch.zeros(256))
    again = resnet.init_random_params(seed=0)
    other = resnet.init_random_params(seed=1)
    assert torch.equal(again["conv1.weight"], state["conv1.weight"])
    assert not torch.equal(other["conv1.weight"], state["conv1.weight"])


def test_preprocess_images_is_bit_for_bit():
    rng = np.random.RandomState(1)
    img = np.concatenate([
        np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, -1),
        rng.randint(0, 256, (3, 16, 16, 3)).astype(np.uint8)])
    want = np.asarray(jresnet.preprocess_images(jnp.asarray(img)))
    got = resnet.preprocess_images(torch.from_numpy(img)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(resnet.IMAGENET_MEAN, jresnet.IMAGENET_MEAN)
    np.testing.assert_array_equal(resnet.IMAGENET_STD, jresnet.IMAGENET_STD)
    assert resnet.RESNET152_BLOCKS == jresnet.RESNET152_BLOCKS


@pytest.mark.parametrize("stem_s2d", [False, True], ids=["plain", "s2d"])
def test_bf16_features_round_as_jax_means_do(tree, images, stem_s2d):
    """jnp.mean of bf16 activations returns bf16: the port's features are
    bf16 values widened to float32, as the JAX ones are, and sit within two
    bf16 ulps (relative L2 per image) of them."""
    got = _port_features(tree, images, torch.bfloat16, stem_s2d)
    want = _jax_features(tree, images, jnp.bfloat16, stem_s2d)
    for feats in (got, want):
        as_bf16 = torch.tensor(feats).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(feats, as_bf16)
    rel = (np.linalg.norm(got - want, axis=1)
           / np.linalg.norm(want, axis=1))
    assert rel.max() < 2 * BF16_ULP, rel


@pytest.mark.parametrize("stem_s2d", [False, True], ids=["plain", "s2d"])
def test_make_extractor_on_the_cpu_matches_jax(tree, stem_s2d):
    imgs = np.random.RandomState(2).randint(0, 256, (3, 64, 64, 3),
                                            np.uint8)
    want = _jax_features(tree, np.asarray(jresnet.preprocess_images(
        jnp.asarray(imgs))), stem_s2d=stem_s2d)
    extract = resnet.make_extractor(tree, batch_size=3, dtype=torch.float32,
                                    stem_s2d=stem_s2d, device="cpu")
    got = extract(imgs)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # a tensor batch gives the same; a port state dict loads as the tree
    state = resnet.load_resnet(tree).state_dict()
    again = resnet.make_extractor(state, 3, torch.float32, stem_s2d, "cpu")
    assert torch.equal(again(torch.from_numpy(imgs)), got)


def test_interop_carries_2d_conv_kernels():
    k = np.arange(7 * 5 * 3 * 4, dtype=np.float32).reshape(7, 5, 3, 4)
    key, arr = interop._param_entry("layer1_0.conv2.kernel", k)
    assert key == "layer1_0.conv2.weight" and arr.shape == (4, 3, 7, 5)
    assert arr[2, 1, 6, 4] == k[6, 4, 1, 2]
    params = _jax_tree()
    del params["layer4_0"]["down_bn"]
    with pytest.raises(ValueError, match="missing"):
        resnet.load_resnet(params)
