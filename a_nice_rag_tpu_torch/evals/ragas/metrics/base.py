"""Metric base classes.

Mirrors the reference hierarchy (ragas_modified/metrics/base.py): a
Metric ABC with required-column validation, LLM-backed and
embedding-backed mixins with init-time injection, a SingleTurnMetric
with per-call asyncio timeout, and a majority-vote Ensembler.
"""

from __future__ import annotations

import asyncio
from abc import ABC, abstractmethod
from typing import ClassVar, Dict, List, Optional, Set

from a_nice_rag_tpu_torch.evals.ragas.dataset import SingleTurnSample
from a_nice_rag_tpu_torch.evals.ragas.run_config import RunConfig


class Metric(ABC):
    name: ClassVar[str] = ""
    required_columns: ClassVar[Set[str]] = set()

    def init(self, run_config: RunConfig) -> None:
        self.run_config = run_config

    def validate_sample(self, sample: SingleTurnSample) -> None:
        have = set(sample.get_features())
        missing = self.required_columns - have
        if missing:
            raise ValueError(
                f"{self.name} requires columns {sorted(missing)} "
                f"but the sample only has {sorted(have)}"
            )


class MetricWithLLM(Metric):
    llm = None

    def init(self, run_config: RunConfig) -> None:
        super().init(run_config)
        if self.llm is None:
            raise ValueError(
                f"{self.name} requires an LLM; pass one to evaluate() or "
                "set metric.llm"
            )

    # -- prompt surface (reference MetricWithLLM.get_prompts/train,
    # ragas_modified/metrics/base.py:345-427) ------------------------

    def get_prompts(self) -> Dict[str, object]:
        """Named StructuredPrompt attributes of this metric instance."""
        from a_nice_rag_tpu_torch.evals.ragas.prompt import StructuredPrompt

        return {
            name: value
            for name, value in vars(self).items()
            if isinstance(value, StructuredPrompt)
        }

    def set_prompts(self, **prompts) -> None:
        known = self.get_prompts()
        for name, prompt in prompts.items():
            if name not in known:
                raise ValueError(
                    f"{self.name} has no prompt named {name!r}; "
                    f"available: {sorted(known)}"
                )
            setattr(self, name, prompt)

    async def atrain(
        self,
        samples: List[SingleTurnSample],
        targets: List[float],
        prompt_name: Optional[str] = None,
        loss=None,
        generations: int = 3,
        population: int = 4,
        run_config: Optional[RunConfig] = None,
        seed: int = 42,
    ):
        """Optimize one prompt's instruction against labeled samples.

        The reference's train() surface (annotated dataset -> genetic
        instruction optimizer -> prompt updated in place). ``targets``
        are the human/gold scores for ``samples``; fitness of a
        candidate instruction is 1 - loss(metric scores, targets)
        (default MSE). The best instruction is installed on the metric's
        prompt before returning the OptimizationResult.
        """
        from a_nice_rag_tpu_torch.evals.ragas.losses import MSELoss
        from a_nice_rag_tpu_torch.evals.ragas.optimizers import (
            optimize_instruction,
        )

        if len(samples) != len(targets) or not samples:
            raise ValueError("samples and targets must align and be nonempty")
        prompts = self.get_prompts()
        if not prompts:
            raise ValueError(f"{self.name} exposes no trainable prompts")
        if prompt_name is None:
            prompt_name = sorted(prompts)[0]
        if prompt_name not in prompts:
            raise ValueError(
                f"no prompt {prompt_name!r}; available: {sorted(prompts)}"
            )
        prompt = prompts[prompt_name]
        loss = loss or MSELoss()
        self.init(run_config or RunConfig())

        async def score_fn(instruction: str) -> float:
            original = prompt.instruction
            prompt.instruction = instruction
            try:
                preds = []
                for s in samples:
                    preds.append(float(await self._single_turn_ascore(s)))
            finally:
                prompt.instruction = original
            return 1.0 - float(loss(preds, list(targets)))

        result = await optimize_instruction(
            self.llm,
            prompt.instruction,
            score_fn,
            generations=generations,
            population=population,
            seed=seed,
        )
        prompt.instruction = result.best_instruction
        return result

    def train(self, samples, targets, **kwargs):
        """Synchronous wrapper over :meth:`atrain`."""
        return asyncio.run(self.atrain(samples, targets, **kwargs))


class MetricWithEmbeddings(Metric):
    embeddings = None

    def init(self, run_config: RunConfig) -> None:
        super().init(run_config)
        if self.embeddings is None:
            raise ValueError(
                f"{self.name} requires embeddings; pass them to evaluate() "
                "or set metric.embeddings"
            )


class SingleTurnMetric(Metric):
    @abstractmethod
    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        ...

    async def single_turn_ascore(
        self,
        sample: SingleTurnSample,
        timeout: Optional[float] = None,
    ) -> float:
        self.validate_sample(sample)
        timeout = timeout or getattr(
            getattr(self, "run_config", None), "timeout", None
        )
        coro = self._single_turn_ascore(sample)
        if timeout:
            return await asyncio.wait_for(coro, timeout=timeout)
        return await coro


class MultiTurnMetric(Metric):
    """Metrics over conversational MultiTurnSample transcripts."""

    @abstractmethod
    async def _multi_turn_ascore(self, sample) -> float:
        ...

    async def multi_turn_ascore(
        self, sample, timeout: Optional[float] = None
    ) -> float:
        timeout = timeout or getattr(
            getattr(self, "run_config", None), "timeout", None
        )
        coro = self._multi_turn_ascore(sample)
        if timeout:
            return await asyncio.wait_for(coro, timeout=timeout)
        return await coro


class Ensembler:
    """Majority vote across repeated LLM verdicts (strictness > 1)."""

    @staticmethod
    def from_discrete(
        inputs: List[List[Dict]], attribute: str
    ) -> List[Dict]:
        """inputs: per-repetition lists of verdict dicts (same length);
        returns one list with the majority value per position."""
        if not inputs:
            return []
        n_items = len(inputs[0])
        out = []
        for i in range(n_items):
            votes: Dict = {}
            for rep in inputs:
                v = rep[i][attribute]
                votes[v] = votes.get(v, 0) + 1
            best = max(votes.items(), key=lambda kv: kv[1])[0]
            merged = dict(inputs[0][i])
            merged[attribute] = best
            out.append(merged)
        return out
