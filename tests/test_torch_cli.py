"""``python -m chattts_tpu_torch.examples.cli`` at the tiny config on the
CPU: it writes readable 24 kHz wavs, falls back to random weights where no
tree is found, and exits 1 on a tree the trusted checksums refuse."""

import logging
import wave

import numpy as np
import pytest

from chattts_tpu_torch.examples import cli
from torch_port_utils import port_config, write_tiny_tree

ARGS = ["--device", "cpu", "--max-new", "16", "--min-new", "4",
        "--manual-seed", "3", "--skip-refine", "--no-progress"]


def _read(path):
    with wave.open(str(path), "rb") as w:
        assert w.getframerate() == 24000
        assert w.getnchannels() == 1 and w.getsampwidth() == 2
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    assert pcm.size > 0
    return pcm


@pytest.mark.parametrize("extra", [[], ["--stream"], ["--seed", "5"]],
                         ids=["oneshot", "stream", "speaker_seed"])
def test_cli_writes_a_readable_wav(tiny_config, tmp_path, extra):
    out = tmp_path / "out"
    rc = cli.main(["hello world."] + ARGS + ["--source", "random",
                                              "-o", str(out)] + extra,
                  config=port_config(tiny_config))
    assert rc == 0
    _read(f"{out}.wav")


def test_cli_one_wav_per_text_without_split(tiny_config, tmp_path):
    """Two texts are two segments of one utterance (``split_text``), as in
    the reference's runner: one wav."""
    out = tmp_path / "two"
    assert cli.main(["hello world.", "speech on a card"] + ARGS
                    + ["--source", "random", "-o", str(out)],
                    config=port_config(tiny_config)) == 0
    _read(f"{out}.wav")


def test_cli_local_without_a_tree_falls_back(tiny_config, tmp_path,
                                             monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("CHATTTS_ASSETS", raising=False)
    monkeypatch.setattr(cli.logger, "propagate", True)  # into caplog
    with caplog.at_level(logging.WARNING):
        assert cli.main(["hello world."] + ARGS + ["-o", "local"],
                        config=port_config(tiny_config)) == 0
    assert "falling back to random init" in caplog.text
    _read(tmp_path / "local.wav")


def test_cli_refused_tree_exits_1(tiny_config, tmp_path):
    write_tiny_tree(str(tmp_path / "tree"), tiny_config, np.float32,
                    np.random.default_rng(0))
    assert cli.main(["hello."] + ARGS + ["--source", "custom",
                                          "--custom-path",
                                          str(tmp_path / "tree"),
                                          "-o", str(tmp_path / "no")],
                    config=port_config(tiny_config)) == 1
    assert not (tmp_path / "no.wav").exists()
