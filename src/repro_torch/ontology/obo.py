"""Minimal OBO flat-file parser / writer.

Covers the subset of the OBO 1.4 format that GO and HP releases actually use
for graph extraction: [Term] stanzas with id / name / namespace / is_a /
relationship / is_obsolete. The updater treats the serialized file as the
release artifact (checksummed byte-for-byte, like the paper's downloads).

Streaming (PR 8): the parser consumes any iterable of lines, so
``load_obo`` feeds it the open file handle directly — a GO-sized release
(100k+ terms, tens of MB) is never materialized as one string on the read
path.  ``save_obo`` streams the serialization line-by-line the same way;
``parse_obo``/``write_obo`` keep the whole-string API for small payloads
and byte-checksum callers.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Tuple, Union

from .graph import KnowledgeGraph, TermMeta, Triple


def parse_obo_stream(lines: Iterable[str]) -> KnowledgeGraph:
    """Parse an iterable of OBO lines (an open file handle, a generator, a
    ``splitlines()`` list) into a KnowledgeGraph — O(1) text held beyond
    the accumulating graph itself.

    Obsolete terms are kept in ``terms`` (so labels still resolve — the live
    ontologies keep deprecated ids around) but contribute no triples.
    """
    triples: List[Triple] = []
    terms: Dict[str, TermMeta] = {}

    cur: Dict[str, Union[str, bool, List[Tuple[str, str]]]] = {}
    in_term = False

    def flush() -> None:
        nonlocal cur
        if not cur.get("id"):
            cur = {}
            return
        ident = str(cur["id"])
        meta = TermMeta(
            identifier=ident,
            label=str(cur.get("name", ident)),
            namespace=str(cur.get("namespace", "")),
            obsolete=bool(cur.get("is_obsolete", False)),
            definition=str(cur.get("def", "")),
        )
        terms[ident] = meta
        if not meta.obsolete:
            for rel, target in cur.get("links", []):  # type: ignore[union-attr]
                triples.append((ident, rel, target))
        cur = {}

    for raw in lines:
        line = raw.strip()
        if line.startswith("["):
            flush()
            in_term = line == "[Term]"
            continue
        if not in_term or not line or line.startswith("!"):
            continue
        if ":" not in line:
            continue
        key, _, value = line.partition(":")
        key, value = key.strip(), value.split("!")[0].strip()
        if key == "id":
            cur["id"] = value
        elif key == "name":
            cur["name"] = value
        elif key == "namespace":
            cur["namespace"] = value
        elif key == "def":
            cur["def"] = value.strip('"')
        elif key == "is_obsolete":
            cur["is_obsolete"] = value.lower() == "true"
        elif key == "is_a":
            cur.setdefault("links", []).append(("is_a", value))  # type: ignore[union-attr]
        elif key == "relationship":
            parts = value.split()
            if len(parts) >= 2:
                cur.setdefault("links", []).append((parts[0], parts[1]))  # type: ignore[union-attr]
    flush()

    # Drop triples pointing at unknown targets (dangling imports in real OBO).
    known = set(terms)
    triples = [t for t in triples if t[2] in known]
    kg = KnowledgeGraph.from_triples(triples, terms)
    return kg


def parse_obo(text: str) -> KnowledgeGraph:
    """Parse OBO text (one string) — see :func:`parse_obo_stream`."""
    return parse_obo_stream(text.splitlines())


def iter_obo_lines(kg: KnowledgeGraph, header_version: str) -> Iterator[str]:
    """Yield the OBO serialization line by line (no full-text buffer)."""
    yield "format-version: 1.4"
    yield f"data-version: {header_version}"
    yield "ontology: repro-bio"
    yield ""
    by_head: Dict[str, List[Tuple[str, str]]] = {}
    for h, r, t in kg.string_triples():
        by_head.setdefault(h, []).append((r, t))
    for ident in sorted(kg.terms):
        meta = kg.terms[ident]
        yield "[Term]"
        yield f"id: {ident}"
        yield f"name: {meta.label}"
        if meta.namespace:
            yield f"namespace: {meta.namespace}"
        if meta.obsolete:
            yield "is_obsolete: true"
        for rel, target in sorted(by_head.get(ident, [])):
            if rel == "is_a":
                yield f"is_a: {target}"
            else:
                yield f"relationship: {rel} {target}"
        yield ""


def write_obo(kg: KnowledgeGraph, header_version: str) -> str:
    """Serialize a KnowledgeGraph to OBO text (the 'release artifact')."""
    return "\n".join(iter_obo_lines(kg, header_version))


def load_obo(path: Union[str, Path]) -> KnowledgeGraph:
    """Parse an OBO file, streaming from the handle — the release text is
    never held in memory as one string."""
    with open(path, "r") as fh:
        return parse_obo_stream(fh)


def save_obo(kg: KnowledgeGraph, path: Union[str, Path], header_version: str) -> None:
    """Stream the serialization to ``path``, byte-identical to writing
    ``write_obo(...)`` wholesale (separator-prefix framing, no trailing
    newline added beyond what the line stream carries)."""
    with open(path, "w") as fh:
        first = True
        for line in iter_obo_lines(kg, header_version):
            if not first:
                fh.write("\n")
            fh.write(line)
            first = False
