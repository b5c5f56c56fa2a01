"""Test-set synthesis (reference testset/ package, ~2.6k LoC, rebuilt
compact): a knowledge-graph builder (LLM extractors + embedding
similarity relationships), personas, and single-/multi-hop query
synthesizers producing an EvaluationDataset of
(user_input, reference_contexts, reference) rows.
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from a_nice_rag_tpu_torch.evals.ragas._model import BaseModel

from a_nice_rag_tpu_torch.evals.ragas.dataset import EvaluationDataset, SingleTurnSample
from a_nice_rag_tpu_torch.evals.ragas.prompt import StructuredPrompt


# ---------------------------------------------------------------------------
# Knowledge graph
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KGNode:
    id: str
    content: str
    themes: List[str] = dataclasses.field(default_factory=list)
    entities: List[str] = dataclasses.field(default_factory=list)
    summary: str = ""
    embedding: Optional[np.ndarray] = None


@dataclasses.dataclass
class KGRelationship:
    source: str
    target: str
    type: str
    similarity: float = 0.0


@dataclasses.dataclass
class KnowledgeGraph:
    nodes: List[KGNode] = dataclasses.field(default_factory=list)
    relationships: List[KGRelationship] = dataclasses.field(default_factory=list)

    def node(self, node_id: str) -> KGNode:
        return next(n for n in self.nodes if n.id == node_id)

    def neighbors(self, node_id: str) -> List[Tuple[KGNode, KGRelationship]]:
        out = []
        for r in self.relationships:
            if r.source == node_id:
                out.append((self.node(r.target), r))
            elif r.target == node_id:
                out.append((self.node(r.source), r))
        return out

    def save(self, path: str) -> None:
        payload = {
            "nodes": [
                {
                    "id": n.id,
                    "content": n.content,
                    "themes": n.themes,
                    "entities": n.entities,
                    "summary": n.summary,
                }
                for n in self.nodes
            ],
            "relationships": [dataclasses.asdict(r) for r in self.relationships],
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f)

    @classmethod
    def load(cls, path: str) -> "KnowledgeGraph":
        with open(path, "r", encoding="utf-8") as f:
            payload = json.load(f)
        return cls(
            nodes=[KGNode(**n) for n in payload["nodes"]],
            relationships=[KGRelationship(**r) for r in payload["relationships"]],
        )


class ExtractIn(BaseModel):
    text: str


class ExtractOut(BaseModel):
    summary: str
    themes: List[str]
    entities: List[str]


class NodeExtractionPrompt(StructuredPrompt[ExtractIn, ExtractOut]):
    instruction = (
        "Summarize the passage in one sentence and extract its main "
        "themes and named entities."
    )
    input_model = ExtractIn
    output_model = ExtractOut
    examples = []


async def build_knowledge_graph(
    chunks: Sequence[Dict],
    llm,
    embeddings,
    similarity_threshold: float = 0.5,
    extract: bool = True,
) -> KnowledgeGraph:
    """chunks: dicts with id/title + content. LLM extraction per node plus
    cosine-similarity relationships between node embeddings."""
    prompt = NodeExtractionPrompt()
    nodes: List[KGNode] = []
    for c in chunks:
        node = KGNode(
            id=c.get("id") or c.get("title"), content=c["content"]
        )
        if extract and llm is not None:
            try:
                out = await prompt.generate(llm, ExtractIn(text=c["content"]))
                node.summary = out.summary
                node.themes = out.themes
                node.entities = out.entities
            except Exception:  # noqa: BLE001 — extraction is best-effort
                pass
        nodes.append(node)
    texts = [n.summary or n.content for n in nodes]
    vecs = np.asarray(await embeddings.aembed_texts(texts))
    norms = np.linalg.norm(vecs, axis=1, keepdims=True).clip(1e-9)
    vecs = vecs / norms
    sims = vecs @ vecs.T
    relationships = []
    for i in range(len(nodes)):
        node_i = nodes[i]
        node_i.embedding = vecs[i]
        for j in range(i + 1, len(nodes)):
            shared = set(map(str.lower, node_i.entities)) & set(
                map(str.lower, nodes[j].entities)
            )
            if sims[i, j] >= similarity_threshold or shared:
                relationships.append(
                    KGRelationship(
                        source=node_i.id,
                        target=nodes[j].id,
                        type="entity_overlap" if shared else "similarity",
                        similarity=float(sims[i, j]),
                    )
                )
    return KnowledgeGraph(nodes=nodes, relationships=relationships)


# ---------------------------------------------------------------------------
# Personas + synthesizers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Persona:
    name: str
    role_description: str


DEFAULT_PERSONAS = [
    Persona("gp", "A general practitioner checking treatment guidance."),
    Persona("nurse", "A practice nurse preparing patient advice."),
    Persona("patient", "A patient trying to understand their care options."),
]


class SynthIn(BaseModel):
    persona: str
    context: str


class SynthOut(BaseModel):
    query: str
    reference: str


class SingleHopPrompt(StructuredPrompt[SynthIn, SynthOut]):
    instruction = (
        "Acting as the given persona, write one question answerable from "
        "the context, plus the reference answer drawn from the context."
    )
    input_model = SynthIn
    output_model = SynthOut
    examples = []


class MultiHopPrompt(StructuredPrompt[SynthIn, SynthOut]):
    instruction = (
        "Acting as the given persona, write one question that REQUIRES "
        "combining both context passages to answer, plus the reference "
        "answer synthesized from both."
    )
    input_model = SynthIn
    output_model = SynthOut
    examples = []


class SingleHopQuerySynthesizer:
    def __init__(self, llm, personas: Optional[List[Persona]] = None):
        self.llm = llm
        self.personas = personas or DEFAULT_PERSONAS
        self.prompt = SingleHopPrompt()

    async def generate(self, kg: KnowledgeGraph, n: int, rng: random.Random):
        samples = []
        for _ in range(n):
            node = rng.choice(kg.nodes)
            persona = rng.choice(self.personas)
            out = await self.prompt.generate(
                self.llm,
                SynthIn(persona=persona.role_description, context=node.content),
            )
            samples.append(
                SingleTurnSample(
                    user_input=out.query,
                    reference=out.reference,
                    reference_contexts=[node.content],
                )
            )
        return samples


class MultiHopQuerySynthesizer:
    def __init__(self, llm, personas: Optional[List[Persona]] = None):
        self.llm = llm
        self.personas = personas or DEFAULT_PERSONAS
        self.prompt = MultiHopPrompt()

    async def generate(self, kg: KnowledgeGraph, n: int, rng: random.Random):
        pairs = [
            (kg.node(r.source), kg.node(r.target)) for r in kg.relationships
        ]
        samples = []
        for _ in range(n):
            if not pairs:
                break
            a, b = rng.choice(pairs)
            persona = rng.choice(self.personas)
            ctx = f"Passage 1:\n{a.content}\n\nPassage 2:\n{b.content}"
            out = await self.prompt.generate(
                self.llm,
                SynthIn(persona=persona.role_description, context=ctx),
            )
            samples.append(
                SingleTurnSample(
                    user_input=out.query,
                    reference=out.reference,
                    reference_contexts=[a.content, b.content],
                )
            )
        return samples


async def generate_testset(
    chunks: Sequence[Dict],
    llm,
    embeddings,
    testset_size: int = 10,
    multi_hop_fraction: float = 0.3,
    personas: Optional[List[Persona]] = None,
    seed: int = 42,
) -> EvaluationDataset:
    """End-to-end synthesis: KG build -> mixed single/multi-hop queries."""
    rng = random.Random(seed)
    kg = await build_knowledge_graph(chunks, llm, embeddings)
    n_multi = int(testset_size * multi_hop_fraction)
    single = await SingleHopQuerySynthesizer(llm, personas).generate(
        kg, testset_size - n_multi, rng
    )
    multi = await MultiHopQuerySynthesizer(llm, personas).generate(
        kg, n_multi, rng
    )
    return EvaluationDataset(single + multi)
