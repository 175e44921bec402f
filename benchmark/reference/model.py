"""The networks' shared pieces in plain PyTorch, one graph at a time.

Each network is a file of its own, `nets/<net>.py` by the Config's `net`
(`FVGN.py`, `TransFVGN_v2.py`), whose `forward(net, x, e, face_node, pos)`
is written on the pieces of `Net` below, as Gen-FVGN writes its networks
(`src/FVMmodel/Models/FVGN/EPD.py`, `blocks.py`,
`Models/TransFVGN/TransFVGN_v2.py`): GELU (tanh form) MLPs of two hidden
layers with a trailing LayerNorm (eps 1e-6) except in the decoder; the
EdgeBlock's MLP sees [sum of the neighbours' features at the sender, at
the receiver, the edge]; the NodeBlock sends the first half of the new
edge features to the receiver and the second half to the sender, averages
the neighbours' aggregates and feeds [average, node] to its MLP; both
streams are residual. The Transolver block is physics attention over
learned slice tokens (`physics_attention`) plus a pre-LayerNorm MLP of
ratio 2 with its residual (`premlp_res`); Gen-FVGN's block (`transolver`)
adds the attention to its input without a LayerNorm before it, where
Transolver's own block (arXiv 2402.02366) writes
`x = net.s(x + net.physics_attention(net.layer_norm(x, name + ".ln_1"),
name))` and then `net.premlp_res(x, name)`.

`params` maps the parameter names to float32 tensors. `Net(stream=
"float8")` is the control: the same network computed on a float8 stream;
every piece rounds through `Net.mm` and `Net.s`, so the control holds
every net alike.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.nn import functional as F

from benchmark.harness import spec

Params = Dict[str, torch.Tensor]


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude to the format's largest value, 448), as an fp8 path rounds
    the operands of a product."""
    amax = x.abs().amax().clamp(min=1e-30)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(x.dtype) / s


ROUND = {"float8": fp8_e4m3}


class _StreamMatmul(torch.autograd.Function):
    """x @ w on a stream of a lower type: both operands and the product
    (accumulated in float32) rounded by `r`, as the program rounds its
    stream to bfloat16; in the backward the incoming gradient and the
    gradient of x too."""

    @staticmethod
    def forward(ctx, x, w, r):
        ctx.save_for_backward(x, w)
        ctx.r = r
        return r(r(x) @ r(w))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        r = ctx.r
        gq = r(g)
        gx = r(gq @ r(w).transpose(-1, -2))
        x2 = r(x).reshape(-1, x.shape[-1])
        gw = x2.transpose(0, 1) @ gq.reshape(-1, gq.shape[-1])
        return gx, gw, None


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


class Net:
    """stream None: the float32 reference. stream "float8": the control,
    the same network on a float8 stream: every product's operands and
    result, and every value the program keeps in its stream type
    (activations, LayerNorm outputs, sums over neighbours, residual
    adds), in e4m3."""

    def __init__(self, params: Params, cfg: Dict, stream=None):
        self.p, self.cfg = params, cfg
        self.net = spec.net(cfg["net"])
        if stream is None:
            self.mm, self.s = torch.matmul, _same
        else:
            r = ROUND[stream]
            self.mm = lambda x, w: _StreamMatmul.apply(x, w, r)
            self.s = lambda x: x + (r(x.detach()) - x).detach()

    def dense(self, x, name, bias=True):
        y = self.mm(x, self.p[name + ".kernel"])
        return self.s(y + self.p[name + ".bias"]) if bias else y

    def layer_norm(self, x, name):
        """LayerNorm (eps 1e-6) by the leaves `name.scale`, `name.bias`."""
        return self.s(F.layer_norm(x, x.shape[-1:], self.p[name + ".scale"],
                                   self.p[name + ".bias"], eps=1e-6))

    def mlp(self, x, name, ln=True):
        s = self.s
        h = s(F.gelu(self.dense(x, name + ".hidden_0"), approximate="tanh"))
        h = s(F.gelu(self.dense(h, name + ".hidden_1"), approximate="tanh"))
        h = self.dense(h, name + ".out")
        return self.layer_norm(h, name + ".ln") if ln else h

    def _two_way(self, vs, vr, s, r, n):
        out = vs.new_zeros((n,) + vs.shape[1:])
        return self.s(out.index_add(0, r, vs).index_add(0, s, vr))

    def gn_block(self, x, e, s, r, name):
        n, h = x.shape[0], e.shape[1]
        agg = self._two_way(x[s], x[r], s, r, n)
        e_new = self.mlp(torch.cat([agg[s], agg[r], e], -1),
                         name + ".edge_block.edge_mlp")
        half = e_new.new_zeros((n, h // 2))
        half = self.s(half.index_add(0, r, e_new[:, :h // 2])
                      .index_add(0, s, e_new[:, h // 2:]))
        nbr = self._two_way(half[s], half[r], s, r, n)
        one = torch.ones_like(e_new[:, :1])
        deg = self._two_way(one, one, s, r, n)
        x_new = self.mlp(torch.cat([self.s(nbr / deg.clamp(min=1.0)), x],
                                   -1), name + ".node_block.node_mlp")
        return self.s(x + x_new), self.s(e + e_new)

    def physics_attention(self, x, name):
        """The physics attention of the block `name` over x [N, C]: its
        output after `to_out`, before any residual."""
        c = self.cfg
        heads, g = c["attn_heads"], c["slice_num"]
        d = x.shape[1] // heads
        a = name + ".attn"
        fx = self.dense(x, a + ".in_project_fx").view(-1, heads, d)
        xm = self.dense(x, a + ".in_project_x").view(-1, heads, d)
        temp = self.p[a + ".graph_temperature"].reshape(heads, 1)
        w = self.s(torch.softmax(self.dense(xm, a + ".in_project_slice")
                                 / temp, -1))
        tok = torch.einsum("nhg,nhd->hgd", w, fx) \
            / (w.sum(0)[..., None] + 1e-5)
        q = self.dense(tok, a + ".to_q", bias=False)
        k = self.dense(tok, a + ".to_k", bias=False)
        v = self.dense(tok, a + ".to_v", bias=False)
        att = torch.softmax(q @ k.transpose(-1, -2) * d ** -0.5, -1)
        out = torch.einsum("nhg,hgd->nhd", w, att @ v).reshape(x.shape)
        return self.dense(out, a + ".to_out")

    def premlp_res(self, x, name):
        """x + MLP(LN_2(x)) of the block `name`: ratio 2, GELU."""
        h = self.layer_norm(x, name + ".ln_2")
        h = self.s(F.gelu(self.dense(h, name + ".mlp_pre"),
                          approximate="tanh"))
        return self.s(x + self.dense(h, name + ".mlp_post"))

    def transolver(self, x, name):
        """Gen-FVGN's Transolver block: no LayerNorm before the
        attention."""
        return self.premlp_res(self.s(x + self.physics_attention(x, name)),
                               name)

    def encode(self, x, e):
        """The node and edge encoders."""
        return (self.mlp(self.s(x), "encoder.node_encoder"),
                self.mlp(self.s(e), "encoder.edge_encoder"))

    def decode(self, x):
        return self.s(self.mlp(x, "decoder.node_decoder", ln=False))

    def __call__(self, x, e, face_node, pos):
        """x [N, node inputs], e [E, node inputs + 3], face_node [2, E],
        pos [N, 2] the nodes' coordinates in x's order: the net file's
        `forward`, [N, outputs]."""
        return self.net.forward(self, x, e, face_node, pos)
