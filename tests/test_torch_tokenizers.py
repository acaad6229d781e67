"""The port's tokenizers read from a checkpoint directory's own files, without
``transformers``, ``tokenizers``, ``sentencepiece``, ``regex``, ``ftfy`` or
``protobuf``:

- CLIP's BPE (``models/text/clip_tokenizer``) against the JAX package's
  ``_load_hf_tokenizer(dir, is_clip=True, max_length=77)`` (transformers'
  ``CLIPTokenizer``) over ``vocab.json`` / ``merges.txt`` that the test
  writes: a small BPE learned from docs/eval.md plus the specials. Ids
  equal, bitwise, for fixed prompts and hypothesis text (ASCII, accents,
  CJK, emoji, control characters, prompts that truncate).
- T5's SentencePiece unigram (``models/text/t5_tokenizer``): the JAX T5 path
  cannot run here (``T5Tokenizer`` needs ``sentencepiece``, so the JAX
  embedder tokenizes bytes), so it is held against ``tokenizers``' Unigram
  that ``transformers.convert_slow_tokenizer.T5Converter`` builds from a
  ``spiece.model`` the test writes with
  ``transformers.utils.sentencepiece_model_pb2_new``, with a non-empty
  ``precompiled_charsmap``. Ids equal, bitwise. The fast tokenizer keeps a
  leading space as a piece where sentencepiece (which ``T5Tokenizer`` runs)
  drops leading whitespace: compared texts start with no whitespace, and a
  hand-worked case pins sentencepiece's rule. The published ``spiece.model``
  is not in the repository: a test on it waits until it is.
- ``HFEmbedder`` of both packages over one directory holding weights and
  tokenizer files: the same ids, and embeddings within 1e-4 of their scale
  (fp32, sums in another order).
"""

import collections
import json
import math
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from opensora_torch.models.text import clip_tokenizer, t5_tokenizer
from opensora_torch.models.text.conditioner import load_tokenizer
from torch_parity_utils import CORPUS, max_rel_err, one_torch_thread, write_clip_tokenizer

_one_thread = pytest.fixture(autouse=True)(one_torch_thread)

PROMPTS = [
    "a red panda eating bamboo in a misty forest, 16 FPS. 4 motion score.",
    "Café naïve — résumé! L'été, c'est là-bas.",
    "猫が好き 你好世界 and 한국어",
    "emoji 🐼🎋 x² ½ ①",
    "it's  THE <|endoftext|> end\x07\tok\n",
    "don't ''s'S 123abc 4.5e-3",
    "ÆØÅ ǅungla İstanbul ＦＵＬＬ",
    "",
    "   ",
    "a long prompt " * 40,
]
ALPHABET = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 .,;:!?'\"-()/&") + list(
    "éèàüöçñÉß猫你好世界🐼🎋🎉²½") + ["\x07", "\x1b", "\t", "\n"]


def _words():
    with open(CORPUS, encoding="utf-8") as f:
        return f.read()


# ----------------------------------------------------------------------
# CLIP
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("clip_tok"))
    write_clip_tokenizer(d)
    return d


def _jax_clip_ids(path, texts, max_length=77):
    """The JAX package's tokenization (HFEmbedder.tokenize over
    _load_hf_tokenizer)."""
    from opensora_tpu.models.text.conditioner import _load_hf_tokenizer

    tok = _load_hf_tokenizer(path, is_clip=True, max_length=max_length)
    assert tok is not None
    return tok(texts, truncation=True, max_length=max_length, padding="max_length",
               return_tensors="np")["input_ids"].astype(np.int32)


@pytest.mark.parametrize("prompt", PROMPTS, ids=range(len(PROMPTS)))
def test_clip_ids_equal_the_jax_packages(clip_dir, prompt):
    ours = clip_tokenizer.CLIPTokenizer(clip_dir)([prompt], 77)
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, _jax_clip_ids(clip_dir, [prompt]))


@settings(max_examples=40, derandomize=True, deadline=None)
@given(st.text(alphabet=st.sampled_from(ALPHABET), max_size=120))
def test_clip_ids_equal_the_jax_packages_on_any_text(clip_dir, text):
    np.testing.assert_array_equal(clip_tokenizer.CLIPTokenizer(clip_dir)([text], 77), _jax_clip_ids(clip_dir, [text]))


def test_clip_truncation_keeps_the_end_token_last_and_pads_with_it(clip_dir):
    tok = clip_tokenizer.CLIPTokenizer(clip_dir)
    long, short = tok(["word " * 200, "a"], 77)
    assert long[0] == tok.bos_token_id and long[-1] == tok.eos_token_id
    assert tok.pad_token_id == tok.eos_token_id  # openai's files: pad = <|endoftext|>
    assert list(short[3:]) == [tok.pad_token_id] * 74


def test_clip_special_token_files_set_the_pad_token(clip_dir, tmp_path):
    """``special_tokens_map.json`` naming another pad token (laion's "!"):
    the pad id, and "!" in the text split out as that token, as
    transformers does."""
    d = tmp_path / "clip_pad"
    d.mkdir()
    for f in clip_tokenizer.FILES:
        (d / f).write_bytes(open(os.path.join(clip_dir, f), "rb").read())
    (d / "special_tokens_map.json").write_text(json.dumps({"pad_token": "!", "bos_token": "<|startoftext|>"}))
    (d / "tokenizer_config.json").write_text(json.dumps({"model_max_length": 77}))
    tok = clip_tokenizer.CLIPTokenizer(str(d))
    assert tok.pad_token_id == tok.encoder["!"]
    texts = ["hello! world!!", "x"]
    np.testing.assert_array_equal(tok(texts), _jax_clip_ids(str(d), texts))


def test_load_tokenizer_needs_a_directory_with_all_its_files(clip_dir, tmp_path):
    assert isinstance(load_tokenizer(clip_dir, True, 77), clip_tokenizer.CLIPTokenizer)
    assert load_tokenizer(str(tmp_path), True, 77) is None  # no files: the byte fallback
    assert load_tokenizer(os.path.join(clip_dir, "vocab.json"), True, 77) is None  # a file, not a directory
    assert load_tokenizer("openai/clip-vit-large-patch14", True, 77) is None
    (tmp_path / "vocab.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="merges.txt"):
        load_tokenizer(str(tmp_path), True, 77)


# ----------------------------------------------------------------------
# T5
# ----------------------------------------------------------------------

CHARSMAP_RULES = {"ﬁ": "fi", "Ａ": "A", "Ｂ": "B", " ": " ", "\t": " ", "\n": " ", "①": "1", "™": "TM",
                  "é": "é", "ß": "ss", "…": "..."}


def _write_spiece(path, pieces, charsmap=b"", extra=()):
    """A unigram spiece.model through protobuf: <pad> 0, </s> 1, <unk> 2
    (T5's ids), then ``pieces`` ((piece, score) normal pieces) and
    ``extra`` ((piece, score, type))."""
    from transformers.utils import sentencepiece_model_pb2_new as pb

    m = pb.ModelProto()
    for piece, score, kind in [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2)] + [
            (p, s, 1) for p, s in pieces] + list(extra):
        sp = m.pieces.add()
        sp.piece, sp.score, sp.type = piece, score, kind
    ts = m.trainer_spec
    ts.model_type, ts.unk_id, ts.bos_id, ts.eos_id, ts.pad_id = 1, 2, -1, 1, 0
    ns = m.normalizer_spec
    ns.name = "nmt_nfkc" if charsmap else "identity"
    ns.precompiled_charsmap = charsmap
    ns.add_dummy_prefix = ns.remove_extra_whitespaces = ns.escape_whitespaces = True
    with open(path, "wb") as f:
        f.write(m.SerializeToString())
    return m


@pytest.fixture(scope="module")
def t5_dir(tmp_path_factory):
    """Pieces: the most frequent substrings (up to 8 characters) of
    docs/eval.md's words with the word-start mark, scored by log frequency."""
    counts = collections.Counter()
    for w in _words().lower().split():
        w = "▁" + w
        for i in range(len(w)):
            for j in range(i + 1, min(len(w), i + 8) + 1):
                counts[w[i:j]] += 1
    pieces = [p for p, _ in counts.most_common(3000) if "▁" not in p[1:]]
    total = sum(counts[p] for p in pieces)
    d = tmp_path_factory.mktemp("t5_tok")
    _write_spiece(str(d / "spiece.model"), [(p, math.log(counts[p] / total)) for p in pieces],
                  chip_smoke.build_charsmap(CHARSMAP_RULES))
    return str(d)


def _fast_t5(path):
    """``tokenizers``' Unigram from ``T5Converter``, with T5Tokenizer's 100
    extra ids (lstrip / rstrip, as T5Tokenizer adds them) and <unk> split
    out as special tokens."""
    pytest.importorskip("google.protobuf")
    from tokenizers import AddedToken
    from transformers.convert_slow_tokenizer import T5Converter

    class Slow:  # what T5Converter reads of a T5Tokenizer
        vocab_file = os.path.join(path, "spiece.model")
        _extra_ids, legacy, add_prefix_space = 100, True, True

        def convert_tokens_to_ids(self, token):
            return {"</s>": 1}[token]

    fast = T5Converter(Slow()).converted()
    fast.add_special_tokens([AddedToken(f"<extra_id_{i}>", lstrip=True, rstrip=True, normalized=False, special=True)
                             for i in range(100)] + [AddedToken("<unk>", normalized=False, special=True)])
    return fast


def _fast_ids(fast, text, max_length=64):
    ids = fast.encode(text).ids[:max_length - 1]
    ids = ids if ids and ids[-1] == 1 else ids + [1]
    return np.array([ids + [0] * (max_length - len(ids))], np.int32)


T5_PROMPTS = [p.lstrip() for p in PROMPTS] + [
    "ﬁne Ａpple x\tz ① ™ café straße…",
    "a <extra_id_0> b<extra_id_99>c </s> d",
    "zzqx 猫猫 🐼🐼 ok",
    "the  model   runs",
]


@pytest.mark.parametrize("prompt", T5_PROMPTS, ids=range(len(T5_PROMPTS)))
def test_t5_ids_equal_tokenizers_unigram(t5_dir, prompt):
    ours = t5_tokenizer.T5Tokenizer(t5_dir)([prompt], 64)
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, _fast_ids(_fast_t5(t5_dir), prompt))


@settings(max_examples=40, derandomize=True, deadline=None)
@given(st.text(alphabet=st.sampled_from(ALPHABET[:-4] + ["\t", "\n", "ﬁ", "Ａ", "①", "…", "ß"]), max_size=120))
def test_t5_ids_equal_tokenizers_unigram_on_any_text(t5_dir, text):
    text = text.lstrip()  # sentencepiece drops leading whitespace, the fast tokenizer keeps a piece for it
    np.testing.assert_array_equal(t5_tokenizer.T5Tokenizer(t5_dir)([text], 64), _fast_ids(_fast_t5(t5_dir), text))


@pytest.fixture(scope="module")
def hand_model(tmp_path_factory):
    """Pieces whose scores make the Viterbi's choices known."""
    d = tmp_path_factory.mktemp("t5_hand")
    pieces = [("▁", -3.0), ("▁a", -2.0), ("b", -2.0), ("▁ab", -4.0), ("c", -1.0), ("▁c", -5.0), ("a", -6.0),
              ("bc", -1.5)]
    _write_spiece(str(d / "spiece.model"), pieces, extra=[("<sep>", 0.0, 4)])
    return t5_tokenizer.T5Tokenizer(str(d))


@pytest.mark.parametrize("text, pieces", [
    ("ab", ["▁ab"]),  # "▁a" + "b" ties "▁ab" at -4: the longer last piece wins
    ("abc", ["▁a", "bc"]),  # -3.5 beats "▁ab" + "c" (-5)
    ("c", ["▁", "c"]),  # dummy prefix: "▁" + "c" (-4) beats "▁c" (-5)
    ("a   ab  c", ["▁a", "▁ab", "▁", "c"]),  # repeated spaces are one
    ("   a", ["▁a"]),  # leading spaces dropped (sentencepiece; the fast tokenizer keeps a piece)
    ("xyz", ["▁", "<unk>"]),  # consecutive unknowns merge into one <unk>
    ("x<sep>y", ["▁", "<unk>", "<sep>", "<unk>"]),  # a user-defined piece, copied through the normalizer
])
def test_t5_viterbi_hand_worked(hand_model, text, pieces):
    names = {i: p for i, (p, _, _) in enumerate(hand_model.model.pieces)}
    assert [names[i] for i in hand_model.encode(text)] == pieces


def test_t5_extra_ids_truncation_and_padding(t5_dir):
    tok = t5_tokenizer.T5Tokenizer(t5_dir)
    n = len(tok.model.pieces)
    assert tok.encode("<extra_id_0>") == [n + 99] and tok.encode("<extra_id_99>") == [n]
    assert tok.vocab_size == n + 100
    ids = tok(["word " * 600, "a"], 512)
    assert ids.shape == (2, 512) and ids[0, -1] == tok.eos_token_id and tok.pad_token_id == 0
    assert ids[1, 0] != 0 and ids[1, 1] == 1 and not ids[1, 2:].any()
    assert tok(["a </s>"], 8)[0].tolist().count(1) == 1  # the text's own </s> ends it: none appended


def test_charsmap_matches_tokenizers_precompiled():
    """The darts-clone reader replaces each key as ``tokenizers``'
    ``Precompiled`` does on the same blob, on text whose characters are
    graphemes of one code point (``Precompiled`` works per grapheme,
    sentencepiece per longest key); multi-character keys match longest
    first."""
    from tokenizers.normalizers import Precompiled

    blob = chip_smoke.build_charsmap(CHARSMAP_RULES)
    cm = t5_tokenizer.Charsmap(blob)

    def ours(text):
        data, pos, out = text.encode("utf-8"), 0, b""
        while pos < len(data):
            repl, n = cm.match(data, pos)
            if not n:
                repl, n = data[pos:pos + 1], 1
            out, pos = out + repl, pos + n
        return out.decode("utf-8")

    text = "ﬁne Ａ Ｂ\tx\n① ™ café straße… plain"
    assert ours(text) == Precompiled(blob).normalize_str(text) == "fine A B x 1 TM café strasse... plain"
    longest = t5_tokenizer.Charsmap(chip_smoke.build_charsmap({"a": "1", "abc": "3", "ab": "2"}))
    assert longest.match(b"abcd", 0) == (b"3", 3) and longest.match(b"abd", 0) == (b"2", 2)
    assert longest.match(b"xa", 0) == (None, 0)


def test_model_proto_read_and_written_by_hand_agrees_with_protobuf(t5_dir, tmp_path):
    from transformers.utils import sentencepiece_model_pb2_new as pb

    with open(os.path.join(t5_dir, "spiece.model"), "rb") as f:
        ref = pb.ModelProto.FromString(f.read())
    m = t5_tokenizer.T5Tokenizer(t5_dir).model
    assert [(p.piece, p.score, p.type) for p in ref.pieces] == [(p, np.float32(s), k) for p, s, k in m.pieces]
    assert (m.unk_id, m.bos_id, m.eos_id, m.pad_id) == (2, -1, 1, 0)
    assert m.precompiled_charsmap == ref.normalizer_spec.precompiled_charsmap != b""
    chip_smoke.write_spiece_model(str(tmp_path / "spiece.model"), m)
    with open(tmp_path / "spiece.model", "rb") as f:
        back = pb.ModelProto.FromString(f.read())
    assert [(p.piece, p.score, p.type) for p in back.pieces] == [(p.piece, p.score, p.type) for p in ref.pieces]
    assert (back.trainer_spec.unk_id, back.trainer_spec.bos_id, back.trainer_spec.pad_id) == (2, -1, 0)
    assert back.normalizer_spec.precompiled_charsmap == ref.normalizer_spec.precompiled_charsmap


# ----------------------------------------------------------------------
# HFEmbedder over one directory: weights + tokenizer files
# ----------------------------------------------------------------------


def _weights_dir(module, path, tokenizer_files):
    """``module``'s state dict as a ``model.safetensors`` in HF names beside
    a copy of the tokenizer files; returns the directory and the state dict
    as numpy."""
    from opensora_torch.utils.safetensors_io import save_file

    os.makedirs(path)
    save_file(module.state_dict(), os.path.join(path, "model.safetensors"))
    for f in tokenizer_files:
        with open(f, "rb") as src, open(os.path.join(path, os.path.basename(f)), "wb") as dst:
            dst.write(src.read())
    return path, {k: v.numpy() for k, v in module.state_dict().items()}


def test_clip_embedder_ids_and_embeddings_equal_the_jax_embedders(clip_dir, tmp_path):
    """One directory: random CLIP-L-layout text weights (HF names) and the
    tokenizer files. The JAX embedder tokenizes through transformers and is
    given the same weights through its own converter."""
    from opensora_tpu.models.text.clip import CLIPTextConfig as JCLIPConfig
    from opensora_tpu.models.text.conditioner import HFEmbedder as JEmbedder
    from opensora_tpu.utils.ckpt import convert_clip_text_state_dict

    from opensora_torch.models.text.clip import CLIPTextConfig, CLIPTextModel
    from opensora_torch.models.text.conditioner import HFEmbedder

    with open(os.path.join(clip_dir, "vocab.json"), encoding="utf-8") as f:
        vocab = len(json.load(f))
    cfg = CLIPTextConfig(vocab_size=vocab, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
                         max_position_embeddings=77, eos_token_id=vocab - 1)
    torch.manual_seed(0)
    d, sd = _weights_dir(CLIPTextModel(cfg), str(tmp_path / "clip-vit-tiny"),
                         [os.path.join(clip_dir, f) for f in clip_tokenizer.FILES])
    jax_emb = JEmbedder(from_pretrained=d, max_length=77,
                        clip_config=JCLIPConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__}, dtype="fp32"),
                        params={"params": convert_clip_text_state_dict(sd)})
    ours = HFEmbedder(from_pretrained=d, max_length=77, clip_config=cfg, device="cpu", dtype=torch.float32)
    assert isinstance(ours.tokenizer, clip_tokenizer.CLIPTokenizer) and jax_emb._hf_tokenizer is not None
    texts = PROMPTS[:4]
    np.testing.assert_array_equal(ours.tokenizer(texts), jax_emb.tokenize(texts))
    assert ours.pad_token_id == jax_emb.pad_token_id == vocab - 1
    with torch.no_grad():
        got = ours(texts, added_tokens=3, seq_align=8).numpy()
    assert max_rel_err(got, np.asarray(jax_emb(texts, added_tokens=3, seq_align=8))) <= 1e-4


def test_t5_embedder_tokenizes_with_spiece_and_embeds_as_the_jax_encoder(t5_dir, tmp_path):
    """The JAX embedder cannot read spiece.model here (no sentencepiece), so
    the JAX T5 encoder, given the same weights, is run on the port's ids:
    the same embeddings."""
    from opensora_tpu.models.text.conditioner import HFEmbedder as JEmbedder
    from opensora_tpu.models.text.t5 import T5Config as JT5Config
    from opensora_tpu.utils.ckpt import convert_t5_state_dict

    from opensora_torch.models.text.conditioner import HFEmbedder
    from opensora_torch.models.text.t5 import T5Encoder, t5_small_test_config

    tok = t5_tokenizer.T5Tokenizer(t5_dir)
    port = t5_small_test_config()
    port.vocab_size = tok.vocab_size
    torch.manual_seed(0)
    d, sd = _weights_dir(T5Encoder(port), str(tmp_path / "t5_tiny"), [os.path.join(t5_dir, "spiece.model")])
    ours = HFEmbedder(from_pretrained=d, max_length=32, t5_config=port, device="cpu", dtype=torch.float32)
    assert isinstance(ours.tokenizer, t5_tokenizer.T5Tokenizer) and ours.pad_token_id == 0
    jax_emb = JEmbedder(from_pretrained=d, max_length=32,
                        t5_config=JT5Config(**{k: getattr(port, k) for k in port.__dataclass_fields__}, dtype="fp32"),
                        params={"params": convert_t5_state_dict(sd)})
    texts = [p.lstrip() for p in PROMPTS[:4]]
    ids = ours.tokenizer(texts)
    np.testing.assert_array_equal(ids, tok(texts, 32))
    with torch.no_grad():
        got = ours(texts).numpy()
    assert max_rel_err(got, np.asarray(jax_emb._apply(jax_emb.params, ids))) <= 1e-4


# ----------------------------------------------------------------------
# chip_smoke.py's tokenizer files at the published sizes
# ----------------------------------------------------------------------


def test_chip_smoke_tokenizer_files_match_transformers_and_the_stored_ids(tmp_path):
    """The files chip_smoke.py writes for phase 17a (a 32000-piece
    spiece.model with a non-empty charsmap; a 49408-entry CLIP vocabulary
    with 48894 merges): protobuf and transformers read them, their ids equal
    the port's, and the port's equal the ids chip_smoke.py stores and checks
    on the card."""
    from transformers.utils import sentencepiece_model_pb2_new as pb

    corpus = chip_smoke.tokenizer_corpus()
    t5_dir, clip_dir = str(tmp_path / "t5"), str(tmp_path / "clip")
    assert chip_smoke.write_t5_tokenizer_files(t5_dir, corpus) == 32000
    assert chip_smoke.write_clip_tokenizer_files(clip_dir, corpus) == 49408
    with open(os.path.join(t5_dir, "spiece.model"), "rb") as f:
        proto = pb.ModelProto.FromString(f.read())
    assert len(proto.pieces) == 32000 and [p.piece for p in proto.pieces[:3]] == ["<pad>", "</s>", "<unk>"]
    assert proto.normalizer_spec.precompiled_charsmap
    text = chip_smoke.tokenized_prompt()
    t5, fast = t5_tokenizer.T5Tokenizer(t5_dir), _fast_t5(t5_dir)
    for probe, stored in ((text, chip_smoke.T5_PROMPT_IDS), (chip_smoke.TOK_PROBE, chip_smoke.T5_PROBE_IDS)):
        ours = t5([probe], 64)
        np.testing.assert_array_equal(ours, _fast_ids(fast, probe))
        assert chip_smoke.ids_to_end(ours[0], 1) == stored
    clip = clip_tokenizer.CLIPTokenizer(clip_dir)
    assert len(clip.bpe_ranks) == clip_tokenizer.MAX_MERGES
    assert (clip.bos_token_id, clip.eos_token_id, clip.pad_token_id) == (49406, 49407, 49407)
    ours = clip([text, chip_smoke.TOK_PROBE], 77)
    np.testing.assert_array_equal(ours, _jax_clip_ids(clip_dir, [text, chip_smoke.TOK_PROBE]))
    assert chip_smoke.ids_to_end(ours[0], 49407) == chip_smoke.CLIP_PROMPT_IDS
