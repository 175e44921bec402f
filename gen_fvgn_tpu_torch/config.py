"""Training / solver configuration of the PyTorch port.

The same frozen dataclass as `gen_fvgn_tpu/config.py`, field for field, so a
`config.json` written by either package loads in the other. Fields that the
port does not read yet are kept for that round trip; each comment says what
the field means, not how fast any setting ran.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass


@dataclass(frozen=True)
class Config:
    # network
    net: str = "TransFVGN_v2"          # {"FVGN", "TransFVGN_v1", "TransFVGN_v2"}
    hidden_size: int = 128
    message_passing_num: int = 3
    node_phi_size: int = 3             # uvp channels at the front of x
    node_input_size: int = 12          # uvp(3) + theta_PDE(9)
    node_output_size: int = 3
    attn_heads: int = 8
    slice_num: int = 32

    # training
    n_epochs: int = 210_000
    batch_size: int = 8
    average_sequence_length: int = 500
    dataset_size: int = 100
    lr: float = 5e-5
    min_lr: float = 1e-6
    max_inner_steps: int = 20
    residual_tolerance: float = 1e-7

    # train strategy
    integrator: str = "imex"           # {"explicit", "implicit", "imex"}
    norm_uvp: bool = True
    norm_global: bool = True
    ncn_smooth: bool = True
    conserved_form: bool = True
    order: str = "2nd"                 # WLSQ order {"1st","2nd","3rd","4th"}

    # loss weights
    loss_cont: float = 6e4
    loss_mom: float = 5e4
    loss_press: float = 1.0
    loss_log_floor: float = 0.0        # per-sample floor inside the log loss
                                       # (0 = off)

    # dataset
    dataset_dir: str = "datasets/balanced_datasets"
    export_on_reset: bool = False      # export retiring env solutions on a
                                       # boundary-condition re-roll

    # numerics / engine
    dtype: str = "float32"             # compute dtype for the network
    mxu_dtype: str = "bfloat16"        # matmul input dtype ("float32" to
                                       # disable the bf16 stream)
    dp_devices: int = 1                # data-parallel shard count
    sp_devices: int = 1                # spatial shard count (1 = off)
    engine: str = "segment"            # {"segment", "block"} sparse-op engine
    tile: int = 256                    # block engine: padding granularity of
                                       # the node/face/cell counts
    fv_packed: bool = True             # block engine: run the FV residual
                                       # section once for the whole batch on
                                       # channel-major [rows, C*B] arrays
                                       # (the port does so either way)
    fv_ell: bool = False               # block engine + fv_packed: apply the
                                       # low-degree FV operators through
                                       # k-take tables
    wlsq_block_rows: str = "grad"      # {"grad", "full"}: fold only the
                                       # gradient rows (q=0,1) of the WLSQ
                                       # solve into the operator, or all k
    node_agg: str = "composed"         # NodeBlock aggregation: "composed"
                                       # (adj@scat products precomputed per
                                       # mesh), "split" or "wide"; same math
                                       # and parameter tree
    edge_gather: str = "take"          # EdgeBlock gathered projections:
                                       # "take" (row-gather of node-side
                                       # projections) or "composed"
    microbatch: int = 8                # block engine: chunk size; larger
                                       # batches run as sequential chunks.
                                       # 0 disables.
    bucket_tiers: bool = False         # segment engine: per-size padding tiers
    mixed_case_batches: bool = False   # block engine: sample batches from one
                                       # global permutation across all cases

    @property
    def edge_input_size(self) -> int:
        # relative x (node_input_size) + relative pos (2) + |relative pos| (1)
        return self.node_input_size + 3

    @property
    def wlsq_dim(self) -> int:
        return {"1st": 2, "2nd": 5, "3rd": 9, "4th": 14}[self.order]

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "Config":
        data = json.loads(text)
        fields = {f.name for f in dataclasses.fields(Config)}
        return Config(**{k: v for k, v in data.items() if k in fields})


def load_config(path: str) -> Config:
    with open(path, "rt") as f:
        return Config.from_json(f.read())


def save_config(cfg: Config, path: str) -> None:
    with open(path, "wt") as f:
        f.write(cfg.to_json())
