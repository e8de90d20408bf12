"""Driver: masked-LM pretraining of a BERT-style encoder through
``apex_tpu_torch.train.train_step`` under amp and a fused optimizer.

Set-up makes the weights and a pool of batches on the card from the seed,
builds the amp state, and drives it through its first three steps with
the window's own call on three different batches (these steps are also
the warm-up).  The readings the comparison needs are taken from the
program's state after steps 1 and 3.  The window then cycles through the
pool.  After the window the program's state is freed and the float32
reference replays the first three steps from the same weights, batches
and dropout seeds."""
from __future__ import annotations

import gc
from typing import Dict, List

import torch

from perfbench.lib import compare, frozen
from perfbench.reference import hash as ref_hash
from perfbench.reference import lowp, optim as ref_optim
from perfbench.reference import transformer as ref
from perfbench.reference.tree import leaves

FIRST_STEPS = 3
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def table_rows(c: dict) -> int:
    """Rows of the embedding table (and columns of the tied head): the
    vocabulary padded as the configuration runs it."""
    return c.get("padded_vocab_size", c["vocab_size"])


def _sizes(c: dict) -> Dict[str, tuple]:
    """Every leaf's shape, in the order the weights are drawn."""
    L, D, F = c["num_hidden_layers"], c["hidden_size"], c["intermediate_size"]
    V, P = table_rows(c), c["max_position_embeddings"]
    return {"embed.tok": (V, D), "embed.pos": (P, D),
            "layers.wqkv": (L, D, 3 * D), "layers.wo": (L, D, D),
            "layers.w1": (L, D, F), "layers.w2": (L, F, D)}


def make_params(c: dict, seed: int, device) -> dict:
    """float32 weights from ``seed`` on ``device``: the matrices normal
    x ``initializer_range``, drawn in a fixed order, one call each; layer
    norm gains 1, biases 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    std = c["initializer_range"]
    mats = {k: torch.randn(s, generator=gen, device=device).mul_(std)
            for k, s in _sizes(c).items()}
    L, D, F = c["num_hidden_layers"], c["hidden_size"], c["intermediate_size"]

    def ones(*s):
        return torch.ones(s, device=device)

    def zeros(*s):
        return torch.zeros(s, device=device)

    return {
        "embed": {"tok": mats["embed.tok"], "pos": mats["embed.pos"],
                  "ln_g": ones(D), "ln_b": zeros(D)},
        "layers": {"wqkv": mats["layers.wqkv"], "bqkv": zeros(L, 3 * D),
                   "wo": mats["layers.wo"], "bo": zeros(L, D),
                   "ln1_g": ones(L, D), "ln1_b": zeros(L, D),
                   "w1": mats["layers.w1"], "b1": zeros(L, F),
                   "w2": mats["layers.w2"], "b2": zeros(L, D),
                   "ln2_g": ones(L, D), "ln2_b": zeros(L, D)},
        "head": {"ln_g": ones(D), "ln_b": zeros(D)},
    }


def make_batches(t: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """The pool of masked-LM batches of the traffic ``t``: token ids drawn
    from a Zipf law over the vocabulary (ranks mapped to ids by a seeded
    permutation), ``predictions`` positions a sequence masked as BERT's
    data maker does (80 % the mask id, 10 % a random id, 10 % kept), loss
    weight 1 there and 0 elsewhere.  Every seed gives the same sizes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    V, B, S = t["token_ids"], t["batch"], t["seq_len"]
    k = frozen.masked_positions(S, t["masked_lm_prob"],
                                t["max_predictions_per_seq"])
    ranks = torch.arange(1, V + 1, device=device, dtype=torch.float64)
    zipf = ranks.pow(-t["zipf_exponent"])
    ids = torch.randperm(V, generator=gen, device=device)
    pool = []
    for _ in range(t["pool"]):
        orig = ids[torch.multinomial(zipf, B * S, replacement=True,
                                     generator=gen).view(B, S)]
        pos = torch.rand(B, S, generator=gen, device=device).argsort(1)[:, :k]
        u = torch.rand(B, k, generator=gen, device=device)
        rnd = torch.randint(0, V, (B, k), generator=gen, device=device)
        kept = orig.gather(1, pos)
        new = torch.where(u < 0.8, torch.full_like(kept, t["mask_id"]),
                          torch.where(u < 0.9, kept, rnd))
        tokens = orig.scatter(1, pos, new)
        weights = torch.zeros(B, S, device=device).scatter_(
            1, pos, torch.ones(B, k, device=device))
        pool.append({"tokens": tokens, "targets": orig, "weights": weights})
    return pool


def program_config(c: dict, w: dict):
    """The port's TransformerConfig of configuration ``c`` with every route
    the cell needs passed explicitly."""
    from apex_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(
        vocab_size=table_rows(c), max_len=c["max_position_embeddings"],
        num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        num_heads=c["num_attention_heads"], d_ff=c["intermediate_size"],
        dropout=c["attention_probs_dropout_prob"], causal=False,
        dtype=_DTYPES[w["activation_dtype"]], tie_embeddings=True,
        remat=False, attn_impl=w["attn_impl"], xent_impl=w["xent_impl"])


def make_optimizer(w: dict):
    from apex_tpu_torch.optimizers import FusedLAMB
    o = w["optimizer"]
    if o["name"] != "FusedLAMB":
        raise ValueError(f"transformer_train drives FusedLAMB, not {o['name']}")
    return FusedLAMB(lr=o["lr"], weight_decay=o["weight_decay"],
                     max_grad_norm=o["max_grad_norm"], impl=o["impl"])


class Run:
    """One cell's program, driven from ``seed``."""

    def __init__(self, config: dict, workload: dict, seed: int, device):
        from apex_tpu_torch import amp, train
        self.c, self.w, self.seed, self.device = config, workload, seed, device
        t = workload["mix"]
        self.train = train
        self.cfg = program_config(config, workload)
        params = make_params(config, seed, device)
        self.sizes = [p.numel() for p in leaves(params)]
        self.state = amp.initialize(params, make_optimizer(workload),
                                    opt_level=workload["opt_level"],
                                    verbosity=0)
        del params
        self.pool = make_batches(t, seed + 1, device)
        self.dropout = torch.Generator().manual_seed(seed + 2)
        self.losses: List[torch.Tensor] = []
        self.i = 0
        b1 = workload["optimizer"].get("betas", (0.9, 0.999))[0]
        self.step()
        self.grad1 = [n / (1.0 - b1) for n in compare.flat_leaf_norms(
            self.state.opt_state.m, self.sizes)]
        for _ in range(FIRST_STEPS - 1):
            self.step()
        init = leaves(make_params(config, seed, device))
        self.master_change = compare.flat_leaf_norms(
            self.state.opt_state.master, self.sizes, init)
        dt = self.cfg.dtype
        self.model_change = compare.leaf_norms(
            leaves(self.state.model_params), [p.to(dt) for p in init])
        del init
        self.first_losses = [float(x) for x in self.losses]
        self.losses = []

    # -- the window ---------------------------------------------------------

    @property
    def items_per_step(self) -> int:
        t = self.w["mix"]
        return t["batch"] * t["seq_len"]

    item_unit = "tokens"

    @property
    def flops_per_step(self) -> float:
        c, t = self.c, self.w["mix"]
        k = frozen.masked_positions(t["seq_len"], t["masked_lm_prob"],
                                    t["max_predictions_per_seq"])
        return frozen.bert_step_flops(
            c["num_hidden_layers"], c["hidden_size"], c["intermediate_size"],
            table_rows(c), t["batch"], t["seq_len"], t["batch"] * k)

    @property
    def kernel_shapes(self) -> dict:
        c, t = self.c, self.w["mix"]
        heads = c["num_attention_heads"]
        return {"flash": {"bh": t["batch"] * heads, "s": t["seq_len"],
                          "d": c["hidden_size"] // heads,
                          "dtype": self.w["activation_dtype"],
                          "bias_elems": t["seq_len"]},
                "layer_norm": {"n": t["batch"] * t["seq_len"],
                               "h": c["hidden_size"],
                               "dtype": self.w["activation_dtype"]}}

    def step(self) -> None:
        batch = self.pool[self.i % len(self.pool)]
        self.i += 1
        self.state, loss = self.train.train_step(
            self.state, batch, self.cfg, dropout_rng=self.dropout)
        self.losses.append(loss)

    def finish(self) -> dict:
        """Read the window's losses, then free the program's state."""
        losses = torch.stack(self.losses).float().cpu() if self.losses \
            else torch.zeros(0)
        failed = int((~torch.isfinite(losses)).sum())
        del self.state, self.pool, self.losses
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return {"failed": failed, "notes": []}

    # -- the comparison -------------------------------------------------------

    def program_readings(self) -> dict:
        return {"losses": self.first_losses, "grad1": self.grad1,
                "master_change": self.master_change,
                "model_change": self.model_change}

    def reference_readings(self) -> dict:
        return reference_readings(self.c, self.w, self.seed, self.device)

    def control_readings(self) -> dict:
        return control_readings(self.c, self.w, self.seed, self.device)

    def compare(self) -> List[dict]:
        return compare.judge(gaps(self.program_readings(),
                                  self.reference_readings()),
                             self.w["limits"])


def reference_readings(c: dict, w: dict, seed: int, device,
                       mm=torch.matmul, act=ref.identity) -> dict:
    """The float32 reference's first three steps from the seed's weights,
    batches and dropout seeds (``mm`` and ``act``: its products and
    activations, plain or the control's)."""
    t = w["mix"]
    o = w["optimizer"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = make_params(c, seed, device)
        pool = make_batches(t, seed + 1, device)
        dropout = torch.Generator().manual_seed(seed + 2)
        ps = leaves(params)
        init = [p.clone() for p in ps]
        opt = ref_optim.Lamb(o["lr"], o["weight_decay"], o["max_grad_norm"],
                             betas=tuple(o.get("betas", (0.9, 0.999))))
        losses, grad1 = [], None
        for i in range(FIRST_STEPS):
            seeds = ref_hash.layer_seeds(dropout, c["num_hidden_layers"])
            loss, grads = ref.loss_and_grads(
                params, pool[i], c["num_attention_heads"], seeds,
                c["attention_probs_dropout_prob"], t["reference_chunk"], mm,
                act)
            losses.append(float(loss))
            with torch.no_grad():
                opt.step(ps, grads)
            del grads
            if i == 0:
                grad1 = [float(m.norm()) / (1.0 - opt.b1) for m in opt.m]
        dt = _DTYPES[w["activation_dtype"]]
        return {"losses": losses, "grad1": grad1,
                "change": compare.leaf_norms(ps, init),
                "model_change": compare.leaf_norms(
                    [p.to(dt) for p in ps], [p.to(dt) for p in init])}
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32


def gaps(got: dict, want: dict) -> Dict[str, float]:
    """Every number the calibration reads; the cell's ``limits`` name the
    ones compared.  ``loss1``: the first step's loss (both sides at the
    seed's weights); ``loss``: the worst of the first steps'; ``grad1``:
    the worst leaf's first gradient (``grad1_median``: the median
    leaf's); ``master_change`` / ``model_change``: the worst moved leaf's
    change of the fp32 masters / of the model's copy."""
    include = compare.moved(want["grad1"])
    return {
        "loss1": compare.rel_gap(got["losses"][0], want["losses"][0]),
        "loss": max(compare.rel_gap(a, b)
                    for a, b in zip(got["losses"], want["losses"])),
        "grad1": compare.worst_leaf_gap(got["grad1"], want["grad1"]),
        "grad1_median": compare.median_leaf_gap(got["grad1"],
                                                want["grad1"]),
        "master_change": compare.worst_leaf_gap(
            got["master_change"], want["change"], include),
        "model_change": compare.worst_leaf_gap(
            got["model_change"], want["model_change"], include),
    }


def control_readings(c: dict, w: dict, seed: int, device) -> dict:
    """The control: the reference with its products' operands in float8,
    in the program's place."""
    r = reference_readings(c, w, seed, device, mm=lowp.matmul,
                           act=lowp.round_fp8)
    return {"losses": r["losses"], "grad1": r["grad1"],
            "master_change": r["change"], "model_change": r["model_change"]}
