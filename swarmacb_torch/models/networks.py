"""POCA networks as ``nn.Module``s — ML-Agents architecture.

Counterparts of the flax modules in ``swarmacb_tpu/models/networks.py``
(architecture, activation, init distributions), which re-implement the
reference's torch modules (poca_networks.py):

  LinearEncoder            poca_networks.py:89-119   (Linear+Swish stack)
  EntityEmbedding          poca_networks.py:129-146  (1-layer, T-Fixup init)
  Actor (Gaussian)         poca_networks.py:153-209
  DiscreteActor            poca_networks.py:216-269
  LSTMCell,                poca_networks.py:276-378  (one bias, gate order
  RecurrentDiscreteActor                              [i, f, g, o])
  ResidualSelfAttention    poca_networks.py:381-454
  POCACritic               poca_networks.py:469-635

``POCACritic.all_baselines`` keeps the JAX package's assembled-scores,
W_out-folded form (networks.py:443-517); its fc/LayerNorm/pool tail goes
through ``ops.fused_tail``, or with ``fused_attention=True`` everything from
the raw scores to the pooled rows goes through ``ops.fused_cf_attention``
(networks.py:481-489) — the CUDA kernels on the card, the plain versions on
the CPU. With ``compute_dtype=torch.bfloat16`` (``POCAConfig.mixed_precision``)
the attention projections named in ``mp_stages`` take bfloat16 operands and
round where flax's ``Dense(dtype=bf16)`` rounds (``_project``); everything
after them stays float32, as in the JAX package (networks.py:322-335).
Submodule and parameter names follow the flax tree (``dense_i`` →
``layers.i``, ``kernel`` → ``weight``ᵀ; the LSTM's
``w_ih``, ``w_hh`` and ``bias`` keep the flax names and layout), which
``swarmacb_torch.convert`` relies on.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from . import init as inits

_LOG_2PI = math.log(2.0 * math.pi)
LN_EPS = 1e-5


class LinearEncoder(nn.Module):
    """(Linear → Swish) × num_layers. Matches poca_networks.py:89-119."""

    def __init__(self, input_size: int, num_layers: int, hidden: int,
                 kernel_init: str = "kaiming_normal", kernel_gain: float = 1.0):
        super().__init__()
        sizes = [input_size] + [hidden] * num_layers
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.kernel_init = kernel_init
        self.kernel_gain = kernel_gain

    def init_weights(self, generator: torch.Generator):
        init = inits.KERNEL_INITS[self.kernel_init]
        for layer in self.layers:
            init(layer.weight, generator, self.kernel_gain)
            nn.init.zeros_(layer.bias)

    def forward(self, x):
        for layer in self.layers:
            x = F.silu(layer(x))
        return x


class EntityEmbedding(nn.Module):
    """1-layer LinearEncoder with T-Fixup Normal init
    (poca_networks.py:129-146): gain = (0.125 / embed)^0.5."""

    def __init__(self, input_size: int, embed: int):
        super().__init__()
        self.encoder = LinearEncoder(input_size, 1, embed, "normal",
                                     (0.125 / embed) ** 0.5)

    def init_weights(self, generator: torch.Generator):
        self.encoder.init_weights(generator)

    def forward(self, entities):
        return self.encoder(entities)


# ──────────────────────────────────────────────────────────────────────
#  Actor
# ──────────────────────────────────────────────────────────────────────

class Actor(nn.Module):
    """Gaussian actor: Swish MLP body, raw-linear mean (no tanh squash),
    state-independent log_std. Matches poca_networks.py:153-209."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: int = 256,
                 num_layers: int = 2):
        super().__init__()
        self.net = LinearEncoder(obs_dim, num_layers, hidden)
        self.mu_head = nn.Linear(hidden, act_dim)
        self.log_std = nn.Parameter(torch.zeros(1, act_dim))

    def init_weights(self, generator: torch.Generator):
        self.net.init_weights(generator)
        inits.kaiming_normal_(self.mu_head.weight, generator, 0.2)
        nn.init.zeros_(self.mu_head.bias)
        nn.init.zeros_(self.log_std)

    def forward(self, obs):
        mu = self.mu_head(self.net(obs))
        std = torch.exp(self.log_std.expand_as(mu))
        return mu, std

    @staticmethod
    def log_prob(mu, std, actions):
        """Per-dimension Gaussian log-prob (NOT summed) — ML-Agents computes
        the PPO ratio per action dimension (poca_networks.py:196-209)."""
        var = std**2
        return -((actions - mu) ** 2) / (2 * var) - torch.log(std) - 0.5 * _LOG_2PI

    @staticmethod
    def entropy(std):
        """Summed-over-dims Gaussian entropy (poca_networks.py:202-208)."""
        return (0.5 + 0.5 * _LOG_2PI + torch.log(std)).sum(-1)

    @staticmethod
    def sample(mu, std, noise=None, generator: Optional[torch.Generator] = None):
        """mu + std·ε, with ε given (``noise``) or drawn from ``generator``."""
        if noise is None:
            noise = torch.randn(mu.shape, generator=generator,
                                device=mu.device, dtype=mu.dtype)
        return mu + std * noise


class DiscreteActor(nn.Module):
    """Single-branch categorical actor over the behaviour modules. Matches
    poca_networks.py:216-269."""

    def __init__(self, obs_dim: int, num_actions: int, hidden: int = 256,
                 num_layers: int = 2):
        super().__init__()
        self.net = LinearEncoder(obs_dim, num_layers, hidden)
        self.logits_head = nn.Linear(hidden, num_actions)

    def init_weights(self, generator: torch.Generator):
        self.net.init_weights(generator)
        inits.kaiming_normal_(self.logits_head.weight, generator, 0.2)
        nn.init.zeros_(self.logits_head.bias)

    def forward(self, obs):
        return self.logits_head(self.net(obs))

    @staticmethod
    def log_prob(logits, actions):
        """(…,) log-prob of integer actions under the categorical."""
        logp = F.log_softmax(logits, dim=-1)
        idx = actions.to(torch.int64)[..., None]
        return torch.gather(logp, -1, idx)[..., 0]

    @staticmethod
    def entropy(logits):
        logp = F.log_softmax(logits, dim=-1)
        return -(torch.exp(logp) * logp).sum(-1)

    @staticmethod
    def sample(logits, noise=None, generator: Optional[torch.Generator] = None):
        """Gumbel-argmax, the form ``jax.random.categorical`` samples in:
        argmax(logits + g) with g given (``noise``) or standard Gumbel
        draws −log(−log u), u uniform in [tiny, 1), from ``generator``."""
        if noise is None:
            noise = DiscreteActor.gumbel(torch.rand(
                logits.shape, generator=generator, device=logits.device,
                dtype=logits.dtype))
        return torch.argmax(logits + noise, dim=-1)

    @staticmethod
    def gumbel(u):
        """Standard Gumbel draws −log(−log u) from uniforms u in [0, 1),
        u raised to the dtype's tiny."""
        tiny = torch.finfo(u.dtype).tiny
        return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


class LSTMCell(nn.Module):
    """LSTM cell in the JAX package's layout (networks.py:147-170): stacked
    ``w_ih`` (in, 4M) and ``w_hh`` (M, 4M), ONE bias (4M), gate order
    [i, f, g, o], gates = x @ w_ih + h @ w_hh + b summed in that order.

    ``torch.nn.LSTMCell`` keeps two biases (an Adam step on the second
    would drift from the JAX package's one) and ``nn.LSTM`` cannot zero the
    carry inside a sequence, so neither fits."""

    def __init__(self, input_size: int, memory: int):
        super().__init__()
        self.memory = memory
        self.w_ih = nn.Parameter(torch.empty(input_size, 4 * memory))
        self.w_hh = nn.Parameter(torch.empty(memory, 4 * memory))
        self.bias = nn.Parameter(torch.empty(4 * memory))

    def init_weights(self, generator: torch.Generator):
        inits.lstm_xavier_ih_(self.w_ih, generator)
        inits.lstm_orthogonal_hh_(self.w_hh, generator)
        nn.init.zeros_(self.bias)

    def cell(self, x_w, carry):
        """One step from the input's product ``x_w`` = x @ w_ih:
        → (h, c)."""
        h, c = carry
        gates = x_w + h @ self.w_hh + self.bias
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, c

    def forward(self, carry, x):
        """(carry, x) → (carry, h), flax's ``LSTMCell.__call__``."""
        carry = self.cell(x @ self.w_ih, carry)
        return carry, carry[0]


class RecurrentDiscreteActor(nn.Module):
    """Categorical actor with LSTM memory (cyclamen): Swish MLP body, the
    cell, a logits head. Matches poca_networks.py:276-378 through the JAX
    package's ``RecurrentDiscreteActor`` (networks.py:173-219)."""

    def __init__(self, obs_dim: int, num_actions: int, hidden: int = 128,
                 num_layers: int = 1, memory: int = 128):
        super().__init__()
        self.memory = memory
        self.net = LinearEncoder(obs_dim, num_layers, hidden)
        self.lstm = LSTMCell(hidden, memory)
        self.logits_head = nn.Linear(memory, num_actions)

    def init_weights(self, generator: torch.Generator):
        self.net.init_weights(generator)
        self.lstm.init_weights(generator)
        inits.kaiming_normal_(self.logits_head.weight, generator, 0.2)
        nn.init.zeros_(self.logits_head.bias)

    def initial_state(self, batch: int, device=None):
        z = torch.zeros(batch, self.memory, device=device)
        return (z, z)

    def step(self, obs, carry):
        """One step: obs (B, obs_dim), carry ((B, M), (B, M)) →
        (logits, carry)."""
        carry, out = self.lstm(carry, self.net(obs))
        return self.logits_head(out), carry

    def forward_sequence(self, obs_seq, carry, dones=None):
        """obs_seq (B, T, obs) → (logits (B, T, A), carry).

        The carry is zeroed after every step whose done (B, T) is set, the
        reference's done-masked BPTT (poca_trainer.py:599-608). The body,
        the input products x @ w_ih and the head hold no state, so they run
        once over all B·T rows; only the recurrent product and the gates
        step through time, each step's sum in the cell's order."""
        B, T = obs_seq.shape[:2]
        x_w = (self.net(obs_seq) @ self.lstm.w_ih).unbind(1)
        keep = None if dones is None else (1.0 - dones)[..., None].unbind(1)
        outs = []
        for t in range(T):
            carry = self.lstm.cell(x_w[t], carry)
            outs.append(carry[0])
            if keep is not None:
                carry = (carry[0] * keep[t], carry[1] * keep[t])
        return self.logits_head(torch.stack(outs, 1)), carry


# ──────────────────────────────────────────────────────────────────────
#  Residual self-attention + POCA critic
# ──────────────────────────────────────────────────────────────────────

def _layer_norm(x):
    return F.layer_norm(x, (x.shape[-1],), eps=LN_EPS)


def _project(layer: nn.Linear, x, dtype: Optional[torch.dtype] = None):
    """``layer(x)``, or with ``dtype`` the counterpart of flax's
    ``Dense(dtype=dtype)`` (JAX networks.py:38-41): x, the weight and the
    bias cast to ``dtype``, the product rounded to it, then the bias added
    in it — two roundings, as XLA rounds flax's dot and its bias add.
    ``F.linear`` with the bias would fuse the add into the product and round
    once, which misses flax's result in a quarter of the elements. The
    product sums in float32 before its one rounding; on the card that needs
    cuBLAS's reduced-precision reductions off
    (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``),
    which the entry points set. The parameters stay float32: autograd's
    casts carry their gradients back to float32."""
    if dtype is None:
        return layer(x)
    return torch.matmul(x.to(dtype), layer.weight.to(dtype).t()) + layer.bias.to(dtype)


class ResidualSelfAttention(nn.Module):
    """Pre-norm residual MHA with masked average pooling over entities.

    Matches poca_networks.py:381-454: non-affine LayerNorms (eps 1e-5),
    Normal×T-Fixup projections, residual adds the NORMED input, pooled
    output. Returns (B, embed).

    ``compute_dtype`` (None: float32 throughout) is the operand dtype of the
    projections named in ``mp_stages``, a subset of "qkvo" (JAX
    networks.py:235-256); their outputs keep it, and every product that
    uses them upcasts them to float32 first, as the JAX package's
    ``preferred_element_type=float32`` products and dtype promotions do."""

    NEG_INF = -1e6
    EPSILON = 1e-7

    def __init__(self, embed: int, num_heads: int = 4,
                 compute_dtype: Optional[torch.dtype] = None, mp_stages: str = "qkvo"):
        super().__init__()
        self.embed = embed
        self.num_heads = num_heads
        self.dtypes = {s: compute_dtype if s in mp_stages else None for s in "qkvo"}
        self.fc_q = nn.Linear(embed, embed)
        self.fc_k = nn.Linear(embed, embed)
        self.fc_v = nn.Linear(embed, embed)
        self.fc_out = nn.Linear(embed, embed)

    def init_weights(self, generator: torch.Generator):
        gain = (0.125 / self.embed) ** 0.5
        for layer in (self.fc_q, self.fc_k, self.fc_v, self.fc_out):
            inits.normal_gain_(layer.weight, generator, gain)
            nn.init.zeros_(layer.bias)

    def normalize(self, inp):
        """Pre-norm — per entity, so callers may apply it before tiling
        entity sets (the all_baselines projection dedup)."""
        return _layer_norm(inp)

    def project_qkv(self, x):
        """Q/K/V projections of normalized entities — also per entity."""
        dt = self.dtypes
        return (_project(self.fc_q, x, dt["q"]), _project(self.fc_k, x, dt["k"]),
                _project(self.fc_v, x, dt["v"]))

    def attend(self, x, q, k, v, key_mask: Optional[torch.Tensor] = None):
        """Attention + residual + pooled output from pre-normalized input
        ``x`` (B, N, D) and its per-entity projections."""
        B, N, D = x.shape
        H = self.num_heads
        d = D // H
        qh = q.float().reshape(B, N, H, d).transpose(1, 2)
        kh = k.float().reshape(B, N, H, d).transpose(1, 2)
        vh = v.float().reshape(B, N, H, d).transpose(1, 2)

        attn = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(d)
        if key_mask is not None:
            attn = attn + key_mask[:, None, None, :] * self.NEG_INF
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, vh)
        out = out.transpose(1, 2).reshape(B, N, D)

        # a bfloat16 fc_out output promotes to float32 in the residual add
        output = _layer_norm(_project(self.fc_out, out, self.dtypes["o"]) + x)
        if key_mask is not None:
            valid = (1.0 - key_mask)[..., None]
            return (output * valid).sum(1) / (valid.sum(1) + self.EPSILON)
        return output.mean(dim=1)

    def forward(self, inp, key_mask: Optional[torch.Tensor] = None):
        x = self.normalize(inp)
        q, k, v = self.project_qkv(x)
        return self.attend(x, q, k, v, key_mask)


class POCACritic(nn.Module):
    """Attention-based centralized critic with counterfactual baselines.

    Consumes the 5-D polar STATE, not agent observations
    (poca_networks.py:469-635). ``num_agents`` is the normalising agent
    count: 2n/max − 1 is 1.0 in every reference configuration.
    ``fused_attention`` selects the ``ops.fused_cf_attention`` branch of
    ``all_baselines``; both branches compute the same function with the same
    parameters. ``compute_dtype`` and ``mp_stages`` are the attention's
    (``ResidualSelfAttention``; JAX networks.py:322-353): the parameter tree
    does not depend on them."""

    def __init__(self, state_dim: int, act_dim: int, num_agents: int,
                 hidden: int = 256, num_heads: int = 4, num_layers: int = 2,
                 fused_attention: bool = False,
                 compute_dtype: Optional[torch.dtype] = None, mp_stages: str = "qkvo"):
        super().__init__()
        self.num_agents = num_agents
        self.hidden = hidden
        self.fused_attention = fused_attention
        self.obs_entity_enc = EntityEmbedding(state_dim, hidden)
        self.obs_act_entity_enc = EntityEmbedding(state_dim + act_dim, hidden)
        self.self_attn = ResidualSelfAttention(hidden, num_heads, compute_dtype, mp_stages)
        self.linear_encoder = LinearEncoder(hidden, num_layers, hidden,
                                            "kaiming_normal",
                                            (0.125 / hidden) ** 0.5)
        self.value_head = nn.Linear(hidden + 1, 1)

    def init_weights(self, generator: torch.Generator):
        for m in (self.obs_entity_enc, self.obs_act_entity_enc,
                  self.self_attn, self.linear_encoder):
            m.init_weights(generator)
        inits.torch_linear_default_(self.value_head.weight,
                                    self.value_head.bias, generator)

    def _norm_agent_count(self, n: int) -> float:
        return n * 2.0 / float(self.num_agents) - 1.0

    def _value(self, pooled, n_agents: int):
        """Post-pool tail: linear encoder → (+norm agent count) → value."""
        encoding = self.linear_encoder(pooled)
        nc = torch.full((encoding.shape[0], 1), self._norm_agent_count(n_agents),
                        dtype=encoding.dtype, device=encoding.device)
        return self.value_head(torch.cat([encoding, nc], dim=-1))

    def _encode_and_value(self, entities, n_agents: int):
        """Shared tail: RSA → linear encoder → (+norm agent count) → value."""
        return self._value(self.self_attn(entities), n_agents)

    def critic_pass(self, all_states):
        """Team value V(s): (B, N, state_dim) → (B, 1)."""
        entities = self.obs_entity_enc(all_states)
        return self._encode_and_value(entities, all_states.shape[1])

    def baseline(self, agent_i_state, other_states, other_actions):
        """Single counterfactual baseline b_i: agent i state-only + others
        state+action → (B, 1). Matches poca_networks.py:558-581."""
        ent_i = self.obs_entity_enc(agent_i_state[:, None, :])
        state_act = torch.cat([other_states, other_actions], dim=-1)
        ent_o = self.obs_act_entity_enc(state_act)
        entities = torch.cat([ent_i, ent_o], dim=1)
        return self._encode_and_value(entities, entities.shape[1])

    def all_baselines(self, all_states, all_actions):
        """All N counterfactual baselines in ONE attention pass → (B, N).

        The JAX package's assembled-scores form (networks.py:404-517): the N
        counterfactual entity sets share 2N distinct embeddings, and the
        pre-norm + Q/K/V projections are per entity, so

          1. LN + Q/K/V run on the two (B, N, h) embedding sets only,
          2. the (B, I, H, n, m) scores come from four small products:
             S_aa = q_a·k_aᵀ with row n=I from S_sa, column m=I from S_as,
             and (I, I) from the q_s·k_s diagonal,
          3. fc_out's weight is folded into the per-head values first
             ((attn·v)·W_out = attn·(v·W_out)), with a rank-1 diagonal
             correction from the folded (v_s − v_a), and
          4. the residual is x_a with the diagonal swapped to x_s.

        Steps 3-4 plus LayerNorm and the pool over n are ``ops.fused_tail``;
        with ``fused_attention`` the softmax of step 2 joins them in
        ``ops.fused_cf_attention``, which takes the four raw score products.
        """
        B, N, _ = all_states.shape
        h = self.hidden
        rsa = self.self_attn
        H = rsa.num_heads
        d = h // H
        obs_emb = self.obs_entity_enc(all_states)                        # (B,N,h)
        state_act = torch.cat([all_states, all_actions], dim=-1)
        obs_act_emb = self.obs_act_entity_enc(state_act)                 # (B,N,h)

        x_s = rsa.normalize(obs_emb)
        x_a = rsa.normalize(obs_act_emb)
        q_s, k_s, v_s = rsa.project_qkv(x_s)
        q_a, k_a, v_a = rsa.project_qkv(x_a)

        def heads(t):                                    # (B,N,h) → (B,H,N,d)
            return t.reshape(B, N, H, d).transpose(1, 2)

        qs, ks, vs = heads(q_s), heads(k_s), heads(v_s)
        qa, ka, va = heads(q_a), heads(k_a), heads(v_a)

        # under mixed precision q, k and v may be bfloat16: the scores are
        # float32 products of the upcast operands (JAX networks.py:464-467)
        qs32, ks32, qa32, ka32 = qs.float(), ks.float(), qa.float(), ka.float()
        S_aa = torch.matmul(qa32, ka32.transpose(-1, -2))               # (B,H,n,m)
        S_sa = torch.matmul(qs32, ka32.transpose(-1, -2))
        S_as = torch.matmul(qa32, ks32.transpose(-1, -2))
        S_ss = (qs32 * ks32).sum(-1)                                    # (B,H,N)

        # fold W_out into the per-head values: w[b,h,m,o] = v_h[m]·W_out[h],
        # with W_out in flax layout (in, out) = weightᵀ, split (H, d, h),
        # float32 (the fold uses the parameter, not fc_out's product); v_s − v_a
        # is taken in v's dtype, then upcast, as the JAX package subtracts
        # two bfloat16 values (networks.py:474-478)
        Wh = rsa.fc_out.weight.t().reshape(H, d, h)
        wa = torch.einsum("bhmd,hdo->bhmo", va.float(), Wh)
        dws = torch.einsum("bhmd,hdo->bhmo", (vs - va).float(), Wh)     # (B,H,I,h)

        if self.fused_attention:
            # raw scores to pooled rows in one kernel: the (B, I, H, n, m)
            # score and softmax tensors below never exist
            pooled = ops.fused_cf_attention(
                S_aa, S_as, S_sa, S_ss[..., None].contiguous(),
                wa.contiguous(), dws.contiguous(), x_a.contiguous(),
                (x_s - x_a).contiguous(), rsa.fc_out.bias, d)
            return self._value(pooled.reshape(B * N, h), N).reshape(B, N)

        ii = torch.arange(N, device=all_states.device)
        I_idx = ii.view(1, N, 1, 1, 1)
        n_idx = ii.view(1, 1, 1, N, 1)
        m_idx = ii.view(1, 1, 1, 1, N)
        base = S_aa[:, None]                                   # (B,1,H,n,m)
        row_I = S_sa.permute(0, 2, 1, 3)[:, :, :, None, :]     # (B,I,H,1,m)
        col_I = S_as.permute(0, 3, 1, 2)[:, :, :, :, None]     # (B,I,H,n,1)
        diag_I = S_ss.permute(0, 2, 1)[:, :, :, None, None]    # (B,I,H,1,1)

        scores = torch.where(n_idx == I_idx, row_I, base)
        scores = torch.where(m_idx == I_idx,
                             torch.where(n_idx == I_idx, diag_I, col_I), scores)
        attn = torch.softmax(scores / math.sqrt(d), dim=-1)    # (B,I,H,n,m)

        # the tail is ops.fused_tail in float32 on every device (K3 on the
        # card), the JAX fused_tail=True branch: mp_stages' "v" never reaches
        # the attn×values contraction there (tile_dtype, JAX
        # networks.py:470-472, 519-528, belongs to its XLA tail)
        lhs = attn.permute(0, 1, 3, 2, 4).reshape(B, N * N, H * N)
        # attn[b, I, h, n, m=I], head-major (B, H, I, n)
        attn_mI = attn.diagonal(dim1=1, dim2=4).permute(0, 1, 3, 2).contiguous()
        pooled = ops.fused_tail(lhs.contiguous(), attn_mI,
                                wa.reshape(B, H * N, h).contiguous(),
                                dws.contiguous(), x_a.contiguous(),
                                (x_s - x_a).contiguous(), rsa.fc_out.bias, N)
        return self._value(pooled.reshape(B * N, h), N).reshape(B, N)

    def forward(self, all_states, all_actions):
        """Entry touching every submodule: (team value, baselines)."""
        return self.critic_pass(all_states), self.all_baselines(all_states, all_actions)
