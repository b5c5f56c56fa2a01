"""Prompt-instruction optimization (ragas_modified/optimizers/genetic.py
equivalent, compact): evolve a metric prompt's instruction text against
labeled examples with an LLM-driven mutate/crossover loop, selecting by
agreement with the labels.
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
from typing import Callable, List, Sequence, Tuple


@dataclasses.dataclass
class OptimizationResult:
    best_instruction: str
    best_score: float
    history: List[Tuple[str, float]]


async def _mutate(llm, instruction: str, feedback: str) -> str:
    prompt = (
        "Improve this evaluation-prompt instruction. Keep its intent and "
        "output contract identical; make it clearer and more precise."
        + (f" Known weakness: {feedback}" if feedback else "")
        + f"\n\nInstruction:\n{instruction}\n\nReply with only the "
        "improved instruction."
    )
    return (await llm.agenerate(prompt, n=1, temperature=0.7))[0].strip()


async def _crossover(llm, a: str, b: str) -> str:
    prompt = (
        "Combine the strengths of these two instructions into one "
        "instruction with the same intent and output contract.\n\n"
        f"A:\n{a}\n\nB:\n{b}\n\nReply with only the combined instruction."
    )
    return (await llm.agenerate(prompt, n=1, temperature=0.7))[0].strip()


async def optimize_instruction(
    llm,
    base_instruction: str,
    score_fn: Callable[[str], "asyncio.Future"],
    generations: int = 3,
    population: int = 4,
    seed: int = 42,
) -> OptimizationResult:
    """Genetic loop: seed population by mutating the base instruction,
    then per generation keep the top half, refill with crossovers of
    random survivors. ``score_fn(instruction) -> awaitable float in
    [0, 1]`` (higher = better agreement with labels)."""
    rng = random.Random(seed)
    pool: List[str] = [base_instruction]
    for _ in range(population - 1):
        pool.append(await _mutate(llm, base_instruction, ""))

    history: List[Tuple[str, float]] = []

    async def scored(instructions: Sequence[str]):
        out = []
        for ins in instructions:
            s = float(await score_fn(ins))
            history.append((ins, s))
            out.append((ins, s))
        return sorted(out, key=lambda x: -x[1])

    ranked = await scored(pool)
    for _ in range(generations - 1):
        survivors = [ins for ins, _ in ranked[: max(1, population // 2)]]
        children = []
        while len(survivors) + len(children) < population:
            a, b = rng.choice(survivors), rng.choice(survivors)
            child = (
                await _crossover(llm, a, b)
                if a != b
                else await _mutate(llm, a, "")
            )
            children.append(child)
        ranked = await scored(survivors + children)
    best_ins, best_score = ranked[0]
    return OptimizationResult(best_ins, best_score, history)
