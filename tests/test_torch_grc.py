"""The port's GRC importer (``uwspr_tpu_torch.grc``) against the JAX
package's, and the port CLI's ``grc`` command end to end on the CPU.

The reference's .grc files are not part of the repository, so the
flowgraphs are written here in GRC 3.7 XML with the reference's block keys
and parameters (as tests/test_grc.py writes its own): a live-audio
receiver, a two-wav receiver with a gain and a disabled alternative
source, a c2 receiver with drift, and c2 -> wav and c2 -> soundcard
senders. Both packages must give equal configs (compared through
``test_torch_copies.jax_config``), equal ``classify`` results and equal
``describe`` text; an unmapped topology raises the same ValueError.
"""

import dataclasses

import pytest

from test_torch_copies import jax_config
from uwspr_tpu import grc as jgrc
from uwspr_tpu_torch import cli
from uwspr_tpu_torch import grc as tgrc
from uwspr_tpu_torch.io.c2file import write_c2
from uwspr_tpu_torch.protocol.modulate import synthesize_frame


def _block(key, **params):
    ps = "".join(f"<param><key>{k}</key><value>{v}</value></param>"
                 for k, v in params.items())
    return f"<block><key>{key}</key>{ps}</block>"


def _variable(name, value):
    return _block("variable", id=name, value=value)


def _flowgraph(blocks, connections):
    cs = "".join(f"<connection><source_block_id>{a}</source_block_id>"
                 f"<sink_block_id>{b}</sink_block_id><source_key>0"
                 f"</source_key><sink_key>0</sink_key></connection>"
                 for a, b in connections)
    return ("<?xml version='1.0' encoding='utf-8'?>\n<flow_graph>"
            + "".join(blocks) + cs + "</flow_graph>")


VARIABLES = [_variable("samp_rate", "12000"),
             _variable("Frame_Length", "45000"),
             _variable("Center_Frequency", "1500"),
             _variable("Half_Bandwidth", "10"),
             _variable("Max_Cand_Freqs", "13"),
             _variable("Upper", "Center_Frequency+Half_Bandwidth")]
DECODE_CHAIN = [
    _block("rational_resampler_xxx", id="rr", decim="32", interpolation="1"),
    _block("uwspr_sliding_window_stream_to_pdu", id="sw", fs="375",
           fl="Frame_Length", shift="9", C="2"),
    _block("uwspr_FDR", id="fdr", fs="375", fl="Frame_Length", spb="256",
           maxdrift="0", maxfreqs="Max_Cand_Freqs",
           halfbandwidth="Half_Bandwidth", cf="Center_Frequency",
           threshold="10"),
    _block("uwspr_sync_and_demodulate", id="sd"),
    _block("uwspr_WSPR_unpacker", id="up"),
    _block("blocks_message_debug", id="dbg"),
    _block("qtgui_freq_sink_x", id="scope")]
DECODE_LINKS = [("rr", "sw"), ("sw", "fdr"), ("fdr", "sd"), ("sd", "up"),
                ("up", "dbg")]


def write_flowgraphs(d):
    """The test's flowgraphs in directory ``d`` (with the files they
    name); returns {name: path}."""
    write_c2(d / "frame.c2", synthesize_frame("VE3EMB", "FN25", 30,
                                              freq_offset=1.5))
    for name in ("test_1500_Hz.wav", "whales_12000sps.wav"):
        (d / name).write_bytes(b"")      # classify only checks they exist
    graphs = {
        "live": (VARIABLES + [_block("audio_source", id="mic",
                                     samp_rate="samp_rate")] + DECODE_CHAIN,
                 [("mic", "rr")] + DECODE_LINKS),
        "wav_mix": (VARIABLES + [
            _block("blocks_wavfile_source", id="w0",
                   file="/home/author/test_1500_Hz.wav", repeat="True"),
            _block("blocks_multiply_const_vxx", id="g0", const="0.1"),
            _block("blocks_wavfile_source", id="w1",
                   file="/home/author/whales_12000sps.wav", repeat="True"),
            _block("blocks_add_xx", id="add"),
            _block("audio_source", id="mic", _enabled="0")] + DECODE_CHAIN,
            [("w0", "g0"), ("g0", "add"), ("w1", "add"), ("add", "rr")]
            + DECODE_LINKS),
        "c2": (VARIABLES + [_block("C2_File_Source", id="c2",
                                   file="/home/author/frame.c2",
                                   repeat="False", drift_rate="0.5")]
               + DECODE_CHAIN[1:], [("c2", "sw")] + DECODE_LINKS[1:]),
        "sender_wav": ([_variable("samp_rate", "12000"),
                        _block("C2_File_Source", id="c2",
                               file="/home/author/frame.c2", repeat="False"),
                        _block("blocks_wavfile_sink", id="ws",
                               file="/home/author/out.wav")],
                       [("c2", "ws")]),
        "sender_audio": ([_variable("samp_rate", "12000"),
                          _block("C2_File_Source", id="c2",
                                 file="/home/author/frame.c2"),
                          _block("audio_sink", id="spk")],
                         [("c2", "spk")]),
    }
    paths = {}
    for name, (blocks, links) in graphs.items():
        paths[name] = d / f"{name}.grc"
        paths[name].write_text(_flowgraph(blocks, links))
    return paths


@pytest.fixture(scope="module")
def flowgraphs(tmp_path_factory):
    d = tmp_path_factory.mktemp("grc")
    return d, write_flowgraphs(d)


KINDS = {"live": ("receiver", "audio"), "wav_mix": ("receiver", "wav_mix"),
         "c2": ("receiver", "c2"), "sender_wav": ("sender", "c2"),
         "sender_audio": ("sender", "c2")}


@pytest.mark.parametrize("name", list(KINDS))
def test_flowgraph_maps_as_in_jax(flowgraphs, name):
    d, paths = flowgraphs
    ft, fj = tgrc.parse_grc(paths[name]), jgrc.parse_grc(paths[name])
    assert ft.variables == fj.variables
    assert ({k: dataclasses.asdict(b) for k, b in ft.blocks.items()}
            == {k: dataclasses.asdict(b) for k, b in fj.blocks.items()})
    assert ft.connections == fj.connections
    assert (dataclasses.asdict(jax_config(tgrc.pipeline_config(ft)))
            == dataclasses.asdict(jgrc.pipeline_config(fj)))
    kt, st, kt_sink = tgrc.classify(ft, str(d))
    kj, sj, kj_sink = jgrc.classify(fj, str(d))
    assert (kt, st.kind) == KINDS[name] == (kj, sj.kind)
    assert dataclasses.asdict(st) == dataclasses.asdict(sj)
    assert ((kt_sink and dataclasses.asdict(kt_sink))
            == (kj_sink and dataclasses.asdict(kj_sink)))
    assert tgrc.describe(ft, str(d)) == jgrc.describe(fj, str(d))


def test_flowgraph_values(flowgraphs):
    d, paths = flowgraphs
    fg = tgrc.parse_grc(paths["wav_mix"])
    assert fg.variables["Upper"] == 1510
    assert "mic" not in fg.blocks          # disabled alternative source
    cfg = tgrc.pipeline_config(fg)
    assert (cfg.coarse.maxfreqs, cfg.stream.shift, cfg.frontend.decimation
            ) == (13, 9, 32)
    _, src, _ = tgrc.classify(fg, str(d))
    assert src.gains == [pytest.approx(0.1), 1.0] and src.repeat
    _, src, _ = tgrc.classify(tgrc.parse_grc(paths["c2"]), str(d))
    assert src.drift_rate == 0.5 and src.files[0] == str(d / "frame.c2")


def test_unmapped_topology_raises_as_in_jax(tmp_path):
    p = tmp_path / "weird.grc"
    p.write_text(_flowgraph([_block("blocks_null_source", id="src0"),
                             _block("blocks_null_sink", id="snk0")],
                            [("src0", "snk0")]))
    with pytest.raises(ValueError) as et:
        tgrc.classify(tgrc.parse_grc(p))
    with pytest.raises(ValueError) as ej:
        jgrc.classify(jgrc.parse_grc(p))
    assert str(et.value) == str(ej.value)
    assert "unrecognized flowgraph topology" in str(et.value)


def test_expression_evaluator_rejects_code():
    names = {"a": 2}
    for expr in ("a*3+1", "-a", "__import__('os')", "firdes.WIN_HAMMING",
                 '"blue"', "True"):
        assert tgrc._resolve(expr, names) == jgrc._resolve(expr, names)
    assert tgrc._resolve("__import__('os')", names) == "__import__('os')"


def test_cli_sender_then_receiver(flowgraphs, tmp_path, capsys):
    """``grc`` on the sender writes the frame's wav; a wav receiver
    flowgraph over that file decodes it (host engine on the CPU)."""
    d, paths = flowgraphs
    out = tmp_path / "sent.wav"
    cli.main(["--device", "cpu", "grc", str(paths["sender_wav"]),
              "-o", str(out), "--files-dir", str(d)])
    assert out.stat().st_size > 2_000_000     # 120 s of 16-bit 12 kS/s
    rx = tmp_path / "rx.grc"
    rx.write_text(_flowgraph(
        VARIABLES + [_block("blocks_wavfile_source", id="w0", file=str(out),
                            repeat="False")] + DECODE_CHAIN,
        [("w0", "rr")] + DECODE_LINKS))
    capsys.readouterr()
    cli.main(["grc", str(rx), "--device", "cpu"])
    cap = capsys.readouterr()
    assert "VE3EMB FN25 30" in cap.out, cap.err
    assert "# 1 windows, 1 spots" in cap.err


def test_cli_show_needs_no_device(flowgraphs, capsys):
    _, paths = flowgraphs
    cli.main(["grc", str(paths["live"]), "--show"])
    assert "source: audio (live stdin)" in capsys.readouterr().err


def test_live_receiver_reads_stdin_without_soundcard(flowgraphs, capsys,
                                                     monkeypatch):
    """No capture backend here: the live receiver says so and reads s16
    from stdin (empty here), decoding nothing."""
    import io
    _, paths = flowgraphs
    monkeypatch.setattr("sys.stdin", io.TextIOWrapper(io.BytesIO(b"")))
    cli.main(["--device", "cpu", "grc", str(paths["live"])])
    err = capsys.readouterr().err
    assert "no soundcard backend; reading s16 audio from stdin" in err
    assert "# 0 windows, 0 spots" in err


def test_capture_errors_propagate(flowgraphs, monkeypatch):
    """An error while a backend captures is not turned into a switch to
    stdin (the JAX CLI's bare except does that)."""
    _, paths = flowgraphs

    class Broken:
        name = "broken"

        def read(self):
            raise OSError("device unplugged")

        def close(self):
            pass

    from uwspr_tpu_torch.io import audio
    real = audio.AudioCapture
    monkeypatch.setattr(audio, "AudioCapture",
                        lambda **kw: real(backend=Broken(), **kw))
    with pytest.raises(OSError, match="device unplugged"):
        cli.main(["--device", "cpu", "grc", str(paths["live"])])
