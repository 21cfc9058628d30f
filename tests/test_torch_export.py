"""flax -> torch export (convert/torch_export.py): bitwise roundtrip
through the importer, strict load into the torch mirror, and forward
parity — the full circle of the interop story."""

import torch_threads  # noqa: F401  (first: torch's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import torch

from basi_tpu.convert.full_import import import_basinet
from basi_tpu.convert.torch_export import export_basinet
from basi_tpu.models.basi import BASINet

from torch_basi import TorchBASINet

STAGE = (1, 1, 1, 1)


def _tiny_variables(seed=0):
    jmodel = BASINet(backbone="resnet_tiny", fpn_channels=64,
                     mask_channels=32, grid_size=8)
    variables = jmodel.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 64, 64, 3)), False)
    # non-trivial BN stats so eval-mode semantics are actually exercised
    stats = jax.tree.map(lambda x: x + 0.05, variables["batch_stats"])
    return jmodel, variables["params"], stats


def test_export_import_roundtrip_bitwise():
    _, params, stats = _tiny_variables()
    sd = export_basinet(jax.device_get(params), jax.device_get(stats),
                        STAGE)
    p2, s2 = import_basinet(sd, STAGE)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(stats), jax.tree.leaves(s2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_export_loads_strict_into_torch_mirror_and_matches(rng):
    jmodel, params, stats = _tiny_variables(seed=1)
    sd = export_basinet(jax.device_get(params), jax.device_get(stats),
                        STAGE)
    tmodel = TorchBASINet(stage_sizes=STAGE, fpn_ch=64, mask_ch=32,
                          grid=8).eval()
    # strict=True: every exported name/shape must match the torch module
    tmodel.load_state_dict(
        {k: torch.from_numpy(np.asarray(v).copy()) for k, v in sd.items()},
        strict=True)

    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        want = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = jmodel.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(x), False)
    np.testing.assert_allclose(
        np.asarray(got.saliency_logits)[..., 0],
        want["saliency"][:, 0].numpy(), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(
        np.asarray(got.cell_scores)[..., 0],
        want["cell_scores"][:, 0].numpy(), atol=1e-3, rtol=1e-3)


def test_export_import_roundtrip_vgg16_and_strict_load(rng):
    """VGG16 variant of the interop circle: bitwise roundtrip (no BN stats
    to carry) + strict torch load + forward parity."""
    jmodel = BASINet(backbone="vgg16", fpn_channels=64, mask_channels=32,
                     grid_size=8)
    variables = jmodel.init(jax.random.PRNGKey(2),
                            jnp.zeros((1, 64, 64, 3)), False)
    params = variables["params"]
    sd = export_basinet(jax.device_get(params), {}, backbone="vgg16")
    p2, s2 = import_basinet(sd, backbone="vgg16")
    assert s2 == {}
    assert jax.tree.structure(params) == jax.tree.structure(p2)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    tmodel = TorchBASINet(fpn_ch=64, mask_ch=32, grid=8,
                          backbone="vgg16").eval()
    tmodel.load_state_dict(
        {k: torch.from_numpy(np.asarray(v).copy()) for k, v in sd.items()},
        strict=True)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        want = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = jmodel.apply({"params": params}, jnp.asarray(x), False)
    np.testing.assert_allclose(
        np.asarray(got.saliency_logits)[..., 0],
        want["saliency"][:, 0].numpy(), atol=1e-3, rtol=1e-3)


def test_cli_export_torch(tmp_path, capsys):
    """basi export --torch: trainer-checkpoint-free path (random init via
    Inferencer), file loads with torch.load and has conv weights in OIHW."""
    import json

    from basi_tpu.cli import main

    args = []
    for kv in ["model.backbone=resnet_tiny", "model.image_size=64",
               "model.grid_size=8", "model.fpn_channels=32",
               "model.mask_channels=32", "data.image_size=64",
               "data.dataset=synthetic", "parallel.num_devices=1"]:
        args += ["--set", kv]
    out = tmp_path / "m.pth"
    rc = main(["export", *args, "--checkpoint", "", "--torch", str(out)])
    assert rc == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["exported_torch"] == str(out) and info["tensors"] > 40
    sd = torch.load(out, map_location="cpu", weights_only=True)
    w = sd["backbone.conv1.weight"]
    assert w.shape[1] == 3 and w.shape[2] == w.shape[3]  # OIHW

    with __import__("pytest").raises(SystemExit, match="--out"):
        main(["export", *args, "--checkpoint", ""])


def test_cli_export_torch_vgg16(tmp_path, capsys):
    """CLI torch export on the VGG16 variant: trunk lands under
    torchvision ``backbone.features.*`` names and strict-loads into the
    mirror."""
    import json

    from basi_tpu.cli import main

    args = []
    for kv in ["model.backbone=vgg16", "model.image_size=64",
               "model.grid_size=8", "model.fpn_channels=32",
               "model.mask_channels=32", "data.image_size=64",
               "data.dataset=synthetic", "parallel.num_devices=1"]:
        args += ["--set", kv]
    out = tmp_path / "m.pth"
    rc = main(["export", *args, "--checkpoint", "", "--torch", str(out)])
    assert rc == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["exported_torch"] == str(out)
    sd = torch.load(out, map_location="cpu", weights_only=True)
    w = sd["backbone.features.0.weight"]
    assert tuple(w.shape) == (64, 3, 3, 3)  # OIHW
    tmodel = TorchBASINet(fpn_ch=32, mask_ch=32, grid=8, backbone="vgg16")
    tmodel.load_state_dict(sd, strict=True)
