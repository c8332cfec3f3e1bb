"""The paper's own pipeline config (FedRF-TCA, Fig. 1): MLP feature extractor
+ RFF compressor + W_RF aligner + classifier, multi-source federated protocol.

A copy of ``repro.configs.fedrf_paper`` against the port's ``ClientConfig``
and ``ProtocolConfig``; ``chip_smoke.py``'s FedRF-TCA phases train at its
width.
"""
from repro_torch.federated.model import ClientConfig
from repro_torch.federated.protocol import ProtocolConfig

CLIENT = ClientConfig(
    input_dim=16,
    n_classes=5,
    extractor_widths=(64, 32),
    n_rff=512,  # N: messages are 2N = 1024 floats (paper uses N=1000)
    m=32,
    lambda_mmd=2.0,
)

PROTOCOL: ProtocolConfig = ProtocolConfig(
    n_rounds=300,
    t_c=50,
    warmup_rounds=200,
    lr=5e-3,
)
