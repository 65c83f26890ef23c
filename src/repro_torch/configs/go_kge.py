"""The paper's own workload: Gene Ontology KGE training + serving.

GO [Aleksander et al., Genetics 2023]: >40 000 classes, three namespaces
(biological_process, molecular_function, cellular_component), is_a majority
plus part_of/regulates side relations, monthly releases. The paper trains
all six KGE models at dim=200 for 100 epochs (PyKEEN defaults otherwise).

Offline adaptation: the synthetic GO generator reproduces those structural
statistics; ``n_terms`` defaults to the full 40k for benchmarks and is
reduced in tests/examples.  The port's copy of ``repro.configs.go_kge``.
"""
import dataclasses

from ..kge import PAPER_DIM, PAPER_EPOCHS
from ..kge.train import TrainConfig
from ..ontology.synthetic import GO_SPEC, OntologySpec


@dataclasses.dataclass(frozen=True)
class KGEWorkload:
    name: str
    spec: OntologySpec
    n_terms: int
    dim: int = PAPER_DIM
    models: tuple = ("transe", "transr", "distmult", "hole", "boxe", "rdf2vec")
    train: TrainConfig = dataclasses.field(
        default_factory=lambda: TrainConfig(epochs=PAPER_EPOCHS))
    n_versions: int = 6          # paper hosts six versions per ontology


CONFIG = KGEWorkload(name="go", spec=GO_SPEC, n_terms=40_000)
REDUCED = KGEWorkload(name="go", spec=GO_SPEC, n_terms=400,
                      train=TrainConfig(epochs=2, batch_size=128))
#: GO-profile release series at KG-Hub scale: 100k terms exercises the
#: streaming top-k residency, 100k-label autocomplete sidecars and OBO
#: stream-parsing end to end.  Short training (the scale axis under test
#: is N, not epochs) keeps train→publish short.
SCALE = KGEWorkload(name="go-scale", spec=GO_SPEC, n_terms=100_000,
                    models=("transe",),
                    train=TrainConfig(epochs=1, batch_size=1024),
                    n_versions=3)
