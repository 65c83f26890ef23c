"""The paper's second workload: Human Phenotype Ontology KGE training.

HP [Köhler et al., NAR 2021]: >18 000 classes, a pure-is_a DAG, releases
every ~1-2 months via GitHub. Same six models, dim=200, 100 epochs.  The
port's copy of ``repro.configs.hp_kge``.
"""

from ..kge.train import TrainConfig
from ..ontology.synthetic import HP_SPEC
from .go_kge import KGEWorkload

CONFIG = KGEWorkload(name="hp", spec=HP_SPEC, n_terms=18_000)
REDUCED = KGEWorkload(name="hp", spec=HP_SPEC, n_terms=300,
                      train=TrainConfig(epochs=2, batch_size=128))
