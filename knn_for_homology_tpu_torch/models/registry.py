"""Embedder registry (port of knn_for_homology_tpu/models/registry.py).

Uniform interface, as in the reference's embedder-by-name registry
(reference: cath/embed.py:34-46):

  embed_per_residue(sequences) → iterator of [L_i, d] arrays
  embed_pooled(sequences)      → [N, d] mean-pooled vectors
  reduce_per_protein(emb)      → mean over residues

Encoders: the ProtT5 family (models/t5.py), SeqVec/ELMo (models/elmo.py,
its 4 layer variants exposed as in reference: cath/embed.py:100-105),
ESM/ESM1b/ProtBert/ProtAlbert (models/bert.py), ProtXLNet
(models/xlnet.py), UniRep (models/unirep.py), PLUS-RNN (models/plus_rnn.py),
CPCProt (models/cpcprot.py), and the AA-composition numpy baseline
(reference: cath/embed_all.py:23-44): the JAX package's 13 keys. Every
embedder runs on `device` (the card unless the caller passes "cpu") and
takes `params=` as a tree of tensors or of numpy arrays (a JAX package's
tree included), or `checkpoint=`; without either it raises at
construction.
"""

import functools
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..config import DEFAULT_TOKEN_BATCH, MAX_SEQ_LEN
from ..device import resolve_device
from ..ops.lstm_cuda import lstmp_bidir
from ..ops.short_cuda import short_attention_t5
from ..utils.trace import span
from . import bert, cpcprot, elmo, plus_rnn, t5, unirep, xlnet
from .batching import Batch, make_batches, pad_tokens
from .convert import (
    convert_albert_from_hf,
    convert_bert_from_hf,
    convert_cpcprot_from_torch,
    convert_esm_from_hf,
    convert_plus_rnn_from_torch,
    convert_xlnet_from_hf,
    load_converted,
    load_elmo_checkpoint,
    load_t5_checkpoint,
    load_unirep_checkpoint,
    params_to_torch,
    read_hf_tokenizer_vocab,
)
from .pooling import l2_then_mean_pool, mean_pool


class EmbedderBase:
    name: str = "base"
    dim: int = 0

    def embed_per_residue(
        self, sequences: Sequence[str]
    ) -> Iterator[np.ndarray]:
        raise NotImplementedError

    @staticmethod
    def reduce_per_protein(per_residue: np.ndarray) -> np.ndarray:
        """Mean over the residue axis (reference: cath/embed.py:91-94)."""
        return np.asarray(per_residue, dtype=np.float32).mean(axis=0)

    def embed_pooled(self, sequences: Sequence[str]) -> np.ndarray:
        if not sequences:
            return np.zeros((0, self.dim), dtype=np.float32)
        return np.stack(
            [self.reduce_per_protein(e) for e in self.embed_per_residue(sequences)]
        )


class BatchedEmbedder(EmbedderBase):
    """An encoder run over length-sorted batches: subclasses give
    batches(sequences), run_batch(batch) → the batch's output on the device
    (by default the encoder on token_arrays(batch)), and residues(output,
    row, sequence) → that row's per-residue array.

    One that sets `device_pools` gives token_arrays(batch) too (and
    token_len(batch) where its rows are longer than the batch's padded
    length): embed_pooled then pools each batch on the device (`pool`, a
    masked mean) and copies only the pooled rows to the host; the others
    average their per-residue arrays on the host (EmbedderBase)."""

    device_pools = False

    def batches(self, sequences: Sequence[str]) -> List[Batch]:
        raise NotImplementedError

    def run_batch(self, batch: Batch) -> torch.Tensor:
        ids, mask, _ = self._tokens(batch)
        return self.encode_tokens(batch, ids, mask)

    def encode_tokens(self, batch: Batch, ids: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
        """The encoder on one batch's device tokens."""
        return self.encoder(ids, mask)

    def residues(self, output: np.ndarray, row: int, seq: str) -> np.ndarray:
        raise NotImplementedError

    def token_arrays(self, batch: Batch):
        """(ids, mask, residue mask) host arrays [rows, token_len(batch)]:
        the encoder's input and the positions pooling averages."""
        raise NotImplementedError

    def token_len(self, batch: Batch) -> int:
        """Tokens a row of the batch holds as the encoder sees it."""
        return batch.padded_len

    def pool(self, hidden: torch.Tensor, res_mask: torch.Tensor) -> torch.Tensor:
        return mean_pool(hidden, res_mask)

    def launch_counts(self) -> Dict[str, int]:
        """Running counts of the kernels an encode launches, which the
        `embed.encode` span records the change of: kernel I's."""
        return {"short_launches": short_attention_t5.launches}

    def embed_per_residue(self, sequences):
        results: List[Optional[np.ndarray]] = [None] * len(sequences)
        for batch in self.batches(sequences):
            output = self.run_batch(batch).float().cpu().numpy()
            for row, (idx, seq) in enumerate(
                zip(batch.indices, batch.sequences)
            ):
                results[idx] = self.residues(output, row, seq)
        yield from results

    def _tokens(self, batch: Batch):
        """token_arrays(batch) on the device."""
        with span("embed.tokenize"):
            arrays = self.token_arrays(batch)
        with span("embed.h2d"):
            return _on(self.device, *arrays)

    def pooled_batch(self, batch: Batch) -> torch.Tensor:
        """[rows, d] fp32 pooled vectors of one batch, on the device."""
        ids, mask, res_mask = self._tokens(batch)
        with span("embed.encode") as sp:
            if sp:
                before = self.launch_counts()
            hidden = self.encode_tokens(batch, ids, mask)
            if sp:  # the kernels' launches in this encode
                sp.count(**{k: v - before[k]
                            for k, v in self.launch_counts().items()})
        with span("embed.pool"):
            return self.pool(hidden, res_mask)

    def embed_pooled(self, sequences: Sequence[str]) -> np.ndarray:
        """Pooled on the device where the embedder pools there, returned
        in input order."""
        if not self.device_pools:
            return super().embed_pooled(sequences)
        if not sequences:
            return np.zeros((0, self.dim), dtype=np.float32)
        with span("embed"):
            with span("embed.batching"):
                batches = self.batches(sequences)
            outputs = []
            for batch in batches:
                with span("embed.batch") as sp:
                    if sp:
                        lengths = [len(s) for s in batch.sequences]
                        rows, width = len(lengths), self.token_len(batch)
                        sp.count(residues=sum(lengths), tokens=rows * width,
                                 rows=rows, padded_len=width,
                                 residues_sq=sum(n * n for n in lengths))
                    pooled = self.pooled_batch(batch)
                    with span("embed.d2h"):
                        outputs.append(pooled.cpu().numpy())
            with span("embed.unsort"):
                results: List[Optional[np.ndarray]] = [None] * len(sequences)
                for batch, pooled in zip(batches, outputs):
                    for idx, row in zip(batch.indices, pooled):
                        results[idx] = row
                return np.stack(results)


class ProtT5Embedder(BatchedEmbedder):
    """ProtT5 encoder with token-budget batching + optional L2 pooling
    variant (reference: pfam/embed_t5_fp16.py, pfam/embed_t5_l2.py:69-71),
    on `device` (the card unless the caller passes "cpu")."""

    name = "ProtT5 XL U50"
    dim = 1024
    device_pools = True

    def __init__(
        self,
        checkpoint: Optional[Path] = None,
        config: Optional[t5.T5Config] = None,
        params: Optional[t5.Params] = None,
        token_budget: int = DEFAULT_TOKEN_BATCH,
        max_len: int = MAX_SEQ_LEN,
        l2_per_residue: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.vocab = None  # default = published prot_t5 layout
        if params is not None:
            config = config or t5.PROTT5_XL
        elif checkpoint is not None:
            config, params, self.vocab = load_t5_checkpoint(
                checkpoint, self.device
            )
        else:
            raise _no_checkpoint(self.name)
        self.config = config
        self.encoder = t5.T5Encoder(
            config, params_to_torch(params, self.device, config.dtype))
        self.dim = config.d_model
        self.token_budget = token_budget
        self.max_len = max_len
        self.l2_per_residue = l2_per_residue

    def token_arrays(self, batch: Batch):
        """The residue mask drops EOS, so pooling averages residues only."""
        tokens = [t5.tokenize(s, self.vocab) for s in batch.sequences]
        ids, mask = pad_tokens(tokens, batch.padded_len, t5.PAD_ID)
        res_mask = mask.copy()
        for row, seq in enumerate(batch.sequences):
            res_mask[row, len(seq) :] = False
        return ids, mask, res_mask

    def batches(self, sequences: Sequence[str]) -> List[Batch]:
        return make_batches(sequences, self.token_budget, self.max_len)

    @staticmethod
    def residues(output, row, seq):
        return output[row, : len(seq)]  # drop EOS and padding

    def pool(self, hidden, res_mask):
        """Masked mean; the L2 variant normalises each residue first."""
        pool = l2_then_mean_pool if self.l2_per_residue else mean_pool
        return pool(hidden, res_mask)


def _no_checkpoint(name: str) -> ValueError:
    return ValueError(
        f"{name}: no checkpoint installed — pass `checkpoint=` (the upstream"
        " files or a converted .npz, models/convert.py) or explicit params"
    )


def _on(device, *arrays: np.ndarray) -> List[torch.Tensor]:
    return [torch.from_numpy(a).to(device) for a in arrays]


class SeqVecEmbedder(BatchedEmbedder):
    """ELMo (models/elmo.py); per-residue output is [3, L, 1024] as the
    reference's SeqVec (its layers exposed as Sum/CharCNN/LSTM1/LSTM2,
    reference: cath/embed.py:100-105). A bf16 config serves its recurrence
    on kernel M; pooling (the "SeqVec Sum" vector) is on the device."""

    name = "SeqVec"
    dim = 1024
    device_pools = True

    def __init__(
        self,
        checkpoint: Optional[Path] = None,
        config: Optional[elmo.ElmoConfig] = None,
        params=None,
        max_batch_tokens: int = 16384,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if params is not None:
            config = config or elmo.SEQVEC
        elif checkpoint is not None:
            config, params = load_elmo_checkpoint(checkpoint)
        else:
            raise _no_checkpoint(self.name)
        self.config = config
        self.encoder = elmo.ElmoEncoder(
            config, params_to_torch(params, self.device, config.dtype))
        self.dim = 2 * config.proj_dim
        self.max_batch_tokens = max_batch_tokens

    def batches(self, sequences: Sequence[str]) -> List[Batch]:
        return make_batches(sequences, self.max_batch_tokens, max_len=10**9,
                            bucket=32)

    def token_arrays(self, batch: Batch):
        """Every token is a residue: the residue mask is the mask. The
        encoder's output is [3, rows, padded_len, 2p]."""
        tokens = [elmo.tokenize(s) for s in batch.sequences]
        ids, mask = pad_tokens(tokens, batch.padded_len, 0)
        return ids, mask, mask

    @staticmethod
    def residues(output, row, seq):
        return output[:, row, : len(seq)]

    @staticmethod
    def reduce_per_protein(per_residue: np.ndarray) -> np.ndarray:
        """SeqVec reduce: sum layers, mean residues (bio_embeddings)."""
        return np.asarray(per_residue, dtype=np.float32).sum(0).mean(0)

    def pool(self, hidden, res_mask):
        """reduce_per_protein on the device: the layers' fp32 sum, then
        the mean over the residues."""
        return mean_pool(hidden.float().sum(dim=0), res_mask)

    def encode_tokens(self, batch, ids, mask):
        """The encoder, given the rows' lengths from the host."""
        return self.encoder(ids, mask, [len(s) for s in batch.sequences])

    def launch_counts(self) -> Dict[str, int]:
        """Kernel M's launches and the serial steps they ran."""
        return {"lstm_launches": lstmp_bidir.launches,
                "lstm_steps": lstmp_bidir.steps}

    def embed_layer_variants(
        self, sequences: Sequence[str]
    ) -> Dict[str, np.ndarray]:
        """The reference's 4 saved variants (cath/embed.py:100-105):
        per-protein means of each layer, plus their sum."""
        per_layer = [emb.mean(axis=1)  # mean over residues per layer
                     for emb in self.embed_per_residue(sequences)]
        arr = np.stack(per_layer)  # [N, 3, d]
        return {
            "SeqVec Sum": arr.sum(axis=1),
            "SeqVec CharCNN": arr[:, 0],
            "SeqVec LSTM1": arr[:, 1],
            "SeqVec LSTM2": arr[:, 2],
        }


class BertEmbedder(BatchedEmbedder):
    """BERT-family pLMs: ESM / ESM1b (pre-LN, 1022-aa truncation,
    reference: cath/embed.py:80-82), ProtBert-BFD (post-LN), ProtAlbert-BFD
    (post-LN, shared layers). One encoder (models/bert.py), different
    configs and checkpoints."""

    name = "ESM1b"
    ARCHES = {
        "ESM1b": bert.ESM1B,
        "ESM": bert.ESM1B,
        "ProtBert BFD": bert.PROTBERT,
        "ProtAlbert BFD": bert.PROTALBERT,
    }
    CONVERTERS = {
        "ESM": convert_esm_from_hf,
        "ESM1b": convert_esm_from_hf,
        "ProtBert BFD": convert_bert_from_hf,
        "ProtAlbert BFD": convert_albert_from_hf,
    }

    def __init__(
        self,
        arch: str = "ESM1b",
        checkpoint: Optional[Path] = None,
        config: Optional[bert.BertConfig] = None,
        params=None,
        token_budget: int = DEFAULT_TOKEN_BATCH,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.name = arch
        self.vocab = None  # None = documented per-family default table
        if params is not None:
            config = config or self.ARCHES[arch]
        elif checkpoint is not None:
            path = Path(checkpoint)
            if path.is_dir():  # HF checkpoint: convert in place
                config, params = self.CONVERTERS[arch](path)
                self.vocab = read_hf_tokenizer_vocab(path)
            else:
                config, params, self.vocab = load_converted(
                    path, bert.BertConfig, self.ARCHES[arch])
        else:
            raise _no_checkpoint(arch)
        self.config = config
        self.encoder = bert.BertEncoder(
            config, params_to_torch(params, self.device, config.dtype))
        self.dim = config.d_model
        self.token_budget = token_budget
        # learned positions cap the usable token count (cls + residues + eos)
        self.usable = config.max_positions - config.position_offset
        self.max_len = self.usable - 2
        # each arch family has its own vocabulary + special ids
        if arch in ("ESM", "ESM1b"):
            self._tokenize, self._pad_id = bert.tokenize_esm, bert.ESM_PAD
        else:  # ProtBert / ProtAlbert (BERT WordPiece layout)
            self._tokenize, self._pad_id = bert.tokenize_bert, bert.BERT_PAD

    def batches(self, sequences: Sequence[str]) -> List[Batch]:
        return make_batches(sequences, self.token_budget, self.max_len,
                            bucket=min(128, self.usable))

    def run_batch(self, batch: Batch) -> torch.Tensor:
        """[rows, tokens, d] hidden states on the device (<cls> first)."""
        tokens = [self._tokenize(s, self.max_len, self.vocab)
                  for s in batch.sequences]
        # learned positions cap the padded length
        target = min(batch.padded_len + 2, self.usable)
        ids, mask = pad_tokens(tokens, target, self._pad_id)
        return self.encoder(*_on(self.device, ids, mask))

    def residues(self, output, row, seq):
        return output[row, 1 : 1 + min(len(seq), self.max_len)]  # drop specials


class UniRepEmbedder(BatchedEmbedder):
    """UniRep babbler-1900 mLSTM (models/unirep.py)."""

    name = "UniRep"

    def __init__(
        self,
        checkpoint: Optional[Path] = None,
        config: Optional[unirep.UniRepConfig] = None,
        params=None,
        token_budget: int = DEFAULT_TOKEN_BATCH,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if params is not None:
            config = config or unirep.UNIREP
        elif checkpoint is not None:
            # flat npz (save_params) or a churchlab npy dir / raw TF npz,
            # converted in place (weight-norm gains fused)
            config, params = load_unirep_checkpoint(checkpoint)
        else:
            raise _no_checkpoint(self.name)
        self.config = config
        self.encoder = unirep.UniRepEncoder(
            config, params_to_torch(params, self.device, config.dtype))
        self.dim = config.hidden_dim
        self.token_budget = token_budget

    def batches(self, sequences: Sequence[str]) -> List[Batch]:
        return make_batches(sequences, self.token_budget, 10**9)

    def run_batch(self, batch: Batch) -> torch.Tensor:
        """[rows, padded_len + 1, hidden] on the device (<start> first)."""
        tokens = [unirep.tokenize(s) for s in batch.sequences]
        ids, mask = pad_tokens(tokens, batch.padded_len + 1, unirep.UNIREP_PAD)
        return self.encoder(*_on(self.device, ids, mask))

    @staticmethod
    def residues(output, row, seq):
        return output[row, 1 : 1 + len(seq)]  # drop <start>


class XLNetEmbedder(BatchedEmbedder):
    """ProtXLNet-UniRef100 (models/xlnet.py): Transformer-XL relative
    attention; the specials (<sep> <cls>) sit at the END, so the
    per-residue output is the first len(seq) positions. A bf16 config
    serves through kernel L (models/xlnet.py's fused route); pooling is on
    the device."""

    name = "ProtXLNet UniRef100"
    device_pools = True

    def __init__(
        self,
        checkpoint: Optional[Path] = None,
        config: Optional[xlnet.XLNetConfig] = None,
        params=None,
        token_budget: int = DEFAULT_TOKEN_BATCH,
        max_len: int = MAX_SEQ_LEN,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.vocab = None  # default = documented ProtTrans residue order
        if params is not None:
            config = config or xlnet.PROTXLNET
        elif checkpoint is not None:
            path = Path(checkpoint)
            if path.is_dir():  # HF checkpoint: convert in place
                config, params = convert_xlnet_from_hf(path)
                self.vocab = read_hf_tokenizer_vocab(path)
            else:
                config, params, self.vocab = load_converted(
                    path, xlnet.XLNetConfig, xlnet.PROTXLNET)
        else:
            raise _no_checkpoint(self.name)
        self.config = config
        self.encoder = xlnet.XLNetEncoder(
            config, params_to_torch(params, self.device, config.dtype))
        self.dim = config.d_model
        self.token_budget = token_budget
        self.max_len = max_len

    def batches(self, sequences: Sequence[str]) -> List[Batch]:
        return make_batches(sequences, self.token_budget, self.max_len)

    def token_len(self, batch: Batch) -> int:
        return batch.padded_len + 2  # <sep> <cls>

    def token_arrays(self, batch: Batch):
        """The residue mask keeps the first len(seq) positions: the
        specials sit after them."""
        tokens = [xlnet.tokenize(s, self.vocab) for s in batch.sequences]
        ids, mask = pad_tokens(tokens, self.token_len(batch), xlnet.XLNET_PAD)
        res_mask = np.zeros_like(mask)
        for row, seq in enumerate(batch.sequences):
            res_mask[row, : len(seq)] = True
        return ids, mask, res_mask

    @staticmethod
    def residues(output, row, seq):
        return output[row, : len(seq)]  # drop <sep> <cls>


class PlusRnnEmbedder(BatchedEmbedder):
    """PLUS-RNN bidirectional LSTM (models/plus_rnn.py); the per-residue
    output is the concatenated fwd/bwd hidden state (2 x hidden_dim)."""

    name = "PLUS"

    def __init__(
        self,
        checkpoint: Optional[Path] = None,
        config: Optional[plus_rnn.PlusRnnConfig] = None,
        params=None,
        token_budget: int = DEFAULT_TOKEN_BATCH,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.vocab = None
        if params is not None:
            config = config or plus_rnn.PLUS_RNN
        elif checkpoint is not None:
            path = Path(checkpoint)
            if path.is_dir() or path.suffix in (".pt", ".bin"):
                config, params = convert_plus_rnn_from_torch(path)
            else:
                config, params, self.vocab = load_converted(
                    path, plus_rnn.PlusRnnConfig, plus_rnn.PLUS_RNN)
        else:
            raise _no_checkpoint(self.name)
        self.config = config
        self.encoder = plus_rnn.PlusRnnEncoder(
            config, params_to_torch(params, self.device, config.dtype))
        self.dim = 2 * config.hidden_dim
        self.token_budget = token_budget

    def batches(self, sequences: Sequence[str]) -> List[Batch]:
        return make_batches(sequences, self.token_budget, 10**9)

    def run_batch(self, batch: Batch) -> torch.Tensor:
        """[rows, padded_len, 2h] on the device."""
        tokens = [plus_rnn.tokenize(s, self.vocab) for s in batch.sequences]
        ids, mask = pad_tokens(tokens, batch.padded_len, 0)
        return self.encoder(*_on(self.device, ids, mask))

    @staticmethod
    def residues(output, row, seq):
        return output[row, : len(seq)]


class CPCProtEmbedder(EmbedderBase):
    """CPCProt (models/cpcprot.py): the sequence is patched (11 residues a
    patch); the "per-residue" output is the per-PATCH z matrix [n_patches,
    z_dim], and reduce_per_protein is its mean (z_mean), the embedding the
    reference consumes. Sequences are grouped by patch count, batch_size a
    group, each padded with empty patches to a multiple of 4 patches."""

    name = "CPCProt"

    def __init__(
        self,
        checkpoint: Optional[Path] = None,
        config: Optional[cpcprot.CPCProtConfig] = None,
        params=None,
        batch_size: int = 64,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.vocab = None
        if params is not None:
            config = config or cpcprot.CPCPROT
        elif checkpoint is not None:
            path = Path(checkpoint)
            if path.is_dir() or path.suffix in (".pt", ".bin"):
                config, params = convert_cpcprot_from_torch(path)
            else:
                config, params, self.vocab = load_converted(
                    path, cpcprot.CPCProtConfig, cpcprot.CPCPROT)
        else:
            raise _no_checkpoint(self.name)
        self.config = config
        self.encoder = cpcprot.CPCProtEncoder(
            config, params_to_torch(params, self.device, config.dtype))
        self.dim = config.z_dim
        self.batch_size = batch_size

    def chunks(self, sequences: Sequence[str]):
        """[(rows' indices, patch ids [rows, t_pad, patch_len])], rows
        sorted by patch count."""
        patched = [cpcprot.tokenize_patches(s, self.config, self.vocab)
                   for s in sequences]
        order = sorted(range(len(patched)), key=lambda i: len(patched[i]))
        out = []
        for start in range(0, len(order), self.batch_size):
            chunk = order[start : start + self.batch_size]
            t_max = max(len(patched[i]) for i in chunk)
            t_pad = -(-t_max // 4) * 4  # bucket to multiples of 4
            ids = np.zeros((len(chunk), t_pad, self.config.patch_len),
                           dtype=np.int32)
            for row, i in enumerate(chunk):
                ids[row, : len(patched[i])] = patched[i]
            out.append((chunk, ids, [len(patched[i]) for i in chunk]))
        return out

    def embed_per_residue(self, sequences):
        results: List[Optional[np.ndarray]] = [None] * len(sequences)
        for chunk, ids, counts in self.chunks(sequences):
            z, _ = self.encoder(*_on(self.device, ids))
            z = z.float().cpu().numpy()
            for row, (i, n) in enumerate(zip(chunk, counts)):
                results[i] = z[row, :n]
        yield from results


class AACompositionEmbedder(EmbedderBase):
    """Amino-acid-composition baseline (reference: cath/embed_all.py:23-44).

    The fixed 25-letter extended alphabet keeps train and test (embedded in
    separate CLI invocations) in one vector space. Unknown characters map
    to 'X'.
    """

    name = "AA Composition"
    DEFAULT_ALPHABET = "ABCDEFGHIKLMNOPQRSTUVWXYZ"  # sorted, stable

    def __init__(self, alphabet: Optional[str] = None):
        self.alphabet = alphabet or self.DEFAULT_ALPHABET
        self.dim = len(self.alphabet)

    def _table(self):
        table = {aa: i for i, aa in enumerate(self.alphabet)}
        fallback = table.get("X", 0)
        return table, fallback

    def embed_pooled(self, sequences: Sequence[str]) -> np.ndarray:
        table, fallback = self._table()
        out = np.zeros((len(sequences), len(self.alphabet)), dtype=np.float32)
        for row, seq in enumerate(sequences):
            for aa in seq.upper():
                out[row, table.get(aa, fallback)] += 1.0
            out[row] /= max(len(seq), 1)
        return out

    def embed_per_residue(self, sequences):
        table, fallback = self._table()
        eye = np.eye(len(self.alphabet), dtype=np.float32)
        for seq in sequences:
            yield np.stack([eye[table.get(aa, fallback)] for aa in seq.upper()])


# name → constructor, the reference's 11-embedder registry (reference:
# cath/embed.py:34-46) + the AA-composition baseline (reference:
# cath/embed_all.py:23-44). The ProtT5 variants share one architecture
# (other checkpoints); so do the ESM/BERT variants.
EMBEDDERS = {
    "ProtT5 XL U50": ProtT5Embedder,
    "ProtT5-BFD": ProtT5Embedder,
    "ProtT5 UniRef50": ProtT5Embedder,
    "SeqVec": SeqVecEmbedder,
    "ESM": functools.partial(BertEmbedder, arch="ESM"),
    "ESM1b": functools.partial(BertEmbedder, arch="ESM1b"),
    "ProtBert BFD": functools.partial(BertEmbedder, arch="ProtBert BFD"),
    "ProtAlbert BFD": functools.partial(BertEmbedder, arch="ProtAlbert BFD"),
    "UniRep": UniRepEmbedder,
    "ProtXLNet UniRef100": XLNetEmbedder,
    "CPCProt": CPCProtEmbedder,
    "PLUS": PlusRnnEmbedder,
    "AA Composition": AACompositionEmbedder,
}


def get_embedder(name: str, **kwargs) -> EmbedderBase:
    if name not in EMBEDDERS:
        raise KeyError(
            f"unknown embedder {name!r}; available: {sorted(EMBEDDERS)}"
        )
    return EMBEDDERS[name](**kwargs)
