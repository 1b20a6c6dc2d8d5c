"""The port's checkpoint key maps are the JAX package's, entry for entry,
at the tiny and the full config; and each covers every leaf of the port's
tree (a leaf no map fills would stay at its template)."""

import pytest
import torch

from chattts_tpu import config as jconfig
from chattts_tpu.models import convnext as jconvnext
from chattts_tpu.models import dvae as jdvae
from chattts_tpu.models import embed as jembed
from chattts_tpu.models import gfsq as jgfsq
from chattts_tpu.models import vocos as jvocos
from chattts_tpu_torch.models import convnext as tconvnext
from chattts_tpu_torch.models import dvae as tdvae
from chattts_tpu_torch.models import embed as tembed
from chattts_tpu_torch.models import gfsq as tgfsq
from chattts_tpu_torch.models import vocos as tvocos
from torch_port_utils import port_config

MAPS = {
    "convnext_decoder": lambda m, c: m.stack_torch_key_map(
        "decoder", "decoder.", c.decoder.stack),
    "convnext_encoder": lambda m, c: m.stack_torch_key_map(
        "encoder", "encoder.", c.dvae.encoder),
    "gfsq": lambda m, c: m.torch_key_map("vq_layer.quantizer.", c.dvae.vq),
    "dvae_decoder": lambda m, c: m.decoder_torch_key_map(c.decoder),
    "dvae": lambda m, c: m.dvae_torch_key_map(c.dvae),
    "vocos": lambda m, c: m.torch_key_map(c.vocos),
    "embed": lambda m, c: m.torch_key_map(c.gpt),
}
MODULES = {"convnext_decoder": (jconvnext, tconvnext),
           "convnext_encoder": (jconvnext, tconvnext),
           "gfsq": (jgfsq, tgfsq), "dvae_decoder": (jdvae, tdvae),
           "dvae": (jdvae, tdvae), "vocos": (jvocos, tvocos),
           "embed": (jembed, tembed)}


@pytest.fixture(params=["tiny", "full"])
def configs(request, tiny_config):
    cfg = tiny_config if request.param == "tiny" else jconfig.Config()
    return cfg, port_config(cfg)


@pytest.mark.parametrize("which", list(MAPS))
def test_key_map_equals_jax(configs, which):
    jcfg, tcfg = configs
    jmod, tmod = MODULES[which]
    want = MAPS[which](jmod, jcfg)
    got = MAPS[which](tmod, tcfg)
    assert got == want
    assert len(got) > 0


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/")


@pytest.mark.parametrize("which", ["dvae", "dvae_decoder", "vocos"])
def test_key_map_covers_every_leaf(configs, which):
    _, cfg = configs
    init = {"dvae": lambda g: tdvae.init_dvae_params(g, cfg.dvae),
            "dvae_decoder": lambda g: tdvae.init_decoder_params(g,
                                                               cfg.decoder),
            "vocos": lambda g: tvocos.init_params(g, cfg.vocos)}[which]
    with torch.device("meta"):
        tree = init(torch.Generator())
    assert set(_leaf_paths(tree)) == set(MAPS[which](
        {"dvae": tdvae, "dvae_decoder": tdvae, "vocos": tvocos}[which], cfg))
