"""PROV-style metadata for published embedding snapshots.

The paper attaches PROV metadata to each Zenodo deposit 'describing the input
ontology, the KGE model used, and the corresponding hyperparameters'. We emit
a small PROV-JSON document (entity / activity / agent / wasGeneratedBy /
used) with exactly that content.
"""
from __future__ import annotations

from typing import Any, Dict

#: the agent string is part of every published metadata.json; it stays the
#: reference's so both packages publish byte-identical snapshots
SOFTWARE_AGENT = "repro:bio-kgvec2go-jax"


def prov_record(
    ontology: str,
    ontology_version: str,
    ontology_checksum: str,
    model_name: str,
    hyperparameters: Dict[str, Any],
    generated_at: str,
    train_stats: Dict[str, Any] | None = None,
) -> Dict[str, Any]:
    ont_ent = f"repro:ontology/{ontology}/{ontology_version}"
    emb_ent = f"repro:embeddings/{ontology}/{ontology_version}/{model_name}"
    activity = f"repro:training/{ontology}/{ontology_version}/{model_name}"
    doc: Dict[str, Any] = {
        "prefix": {"repro": "https://bio.kgvec2go.org/repro#"},
        "entity": {
            ont_ent: {
                "prov:type": "repro:OntologyRelease",
                "repro:checksum_sha256": ontology_checksum,
                "repro:version": ontology_version,
            },
            emb_ent: {
                "prov:type": "repro:EmbeddingSnapshot",
                "repro:model": model_name,
                "repro:hyperparameters": hyperparameters,
            },
        },
        "activity": {
            activity: {
                "prov:type": "repro:KGETraining",
                "prov:endTime": generated_at,
            }
        },
        "agent": {SOFTWARE_AGENT: {"prov:type": "prov:SoftwareAgent"}},
        "wasGeneratedBy": {
            "_:g1": {"prov:entity": emb_ent, "prov:activity": activity}
        },
        "used": {"_:u1": {"prov:activity": activity, "prov:entity": ont_ent}},
        "wasAssociatedWith": {
            "_:a1": {"prov:activity": activity, "prov:agent": SOFTWARE_AGENT}
        },
    }
    if train_stats:
        doc["entity"][emb_ent]["repro:train_stats"] = {
            k: v for k, v in train_stats.items() if not isinstance(v, (list, dict))
        }
    return doc


def validate_prov(doc: Dict[str, Any]) -> bool:
    """Structural validation used by tests and the registry on load."""
    required = ("entity", "activity", "agent", "wasGeneratedBy", "used")
    if not all(k in doc for k in required):
        return False
    gen = next(iter(doc["wasGeneratedBy"].values()))
    used = next(iter(doc["used"].values()))
    return (
        gen["prov:entity"] in doc["entity"]
        and gen["prov:activity"] in doc["activity"]
        and used["prov:entity"] in doc["entity"]
        and used["prov:activity"] in doc["activity"]
    )
