"""Chat application surface.

Counterpart of ``a_nice_rag_tpu/serving/app.py``, the equivalent of the
reference Streamlit app (src/app.py): cached singleton RAG system, model
selector over the provider matrix, streamed answers, expandable sources
with cleaned section ids + guideline URLs, suggested queries, and thumbs
up/down feedback. Runs under Streamlit when it is installed (imported
only then) and falls back to a terminal chat loop otherwise, so the
serve surface always exists. A default ``RAGSystem()`` loads its indexes
on the card.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from a_nice_rag_tpu_torch.rag import RAGSystem
from a_nice_rag_tpu_torch.rag.prompts import clean_section_id
from a_nice_rag_tpu_torch.serving.feedback import FeedbackLog

LLM_OPTIONS = [
    "gpt-4.1-mini",
    "gpt-4.1-nano",
    "gpt-4.1",
    "o4-mini",
    "gemini-2.5-flash",
    "claude-sonnet-4",
]

SUGGESTED_QUERIES = [
    "What are the recommended interventions for smoking cessation in adults?",
    "What groups are at higher risk of ADHD?",
]

DEFAULT_SETTINGS = dict(
    model_weights={"voyage-3-large": 1.0},
    similarity_k=15,
    common_sections_n=15,
    use_hybrid_search=False,
    use_reranker=True,
    reranker_top_k=5,
    filename_type_filter=None,
)


def _stream_answer(system: RAGSystem, query: str, llm_model: str, settings):
    chunks: List[str] = []
    sources_data = []
    for chunk, _, _, sources_data in system.query_rag_stream(
        query, llm_model, **settings
    ):
        chunks.append(chunk)
        yield chunk, sources_data
    return


def run_streamlit(system: Optional[RAGSystem] = None) -> None:
    import streamlit as st

    @st.cache_resource
    def get_system():
        return system or RAGSystem()

    rag = get_system()
    feedback = FeedbackLog()
    st.title("Clinical guidelines assistant")
    llm_model = st.sidebar.selectbox("LLM model", LLM_OPTIONS)
    if "messages" not in st.session_state:
        st.session_state.messages = []
    for m in st.session_state.messages:
        with st.chat_message(m["role"]):
            st.markdown(m["content"])

    cols = st.columns(len(SUGGESTED_QUERIES))
    pending = None
    for col, suggestion in zip(cols, SUGGESTED_QUERIES):
        if col.button(suggestion):
            pending = suggestion
    prompt = st.chat_input("Ask about NICE guidance") or pending
    if prompt:
        st.session_state.messages.append({"role": "user", "content": prompt})
        with st.chat_message("user"):
            st.markdown(prompt)
        with st.chat_message("assistant"):
            placeholder = st.empty()
            text = ""
            sources_data = []
            for chunk, sources_data in _stream_answer(
                rag, prompt, llm_model, DEFAULT_SETTINGS
            ):
                text += chunk
                placeholder.markdown(text)
            st.session_state.messages.append(
                {"role": "assistant", "content": text}
            )
            if sources_data:
                with st.expander("Sources"):
                    for s in sources_data:
                        clean = clean_section_id(s["section_id"], s["source"])
                        st.markdown(f"- [{s['source']} — {clean}]({s['url']})")
            up, down = st.columns(2)
            if up.button("👍"):
                feedback.record(prompt, text, "up", llm_model, sources_data)
            if down.button("👎"):
                feedback.record(prompt, text, "down", llm_model, sources_data)


def run_terminal(system: Optional[RAGSystem] = None, llm_model: str = "fake-llm") -> None:
    rag = system or RAGSystem()
    feedback = FeedbackLog()
    print("Clinical guidelines assistant (terminal). Blank line to quit.")
    for s in SUGGESTED_QUERIES:
        print(f"  suggestion: {s}")
    while True:
        try:
            query = input("\nquery> ").strip()
        except EOFError:
            break
        if not query:
            break
        text = ""
        sources_data = []
        for chunk, _, _, sources_data in rag.query_rag_stream(
            query, llm_model, **DEFAULT_SETTINGS
        ):
            print(chunk, end="", flush=True)
            text += chunk
        print("\n--- sources ---")
        for s in sources_data:
            clean = clean_section_id(s["section_id"], s["source"])
            print(f"  {s['source']} — {clean} ({s['url']})")
        rating = input("feedback [u/d/skip]> ").strip().lower()
        if rating in ("u", "d"):
            feedback.record(
                query, text, "up" if rating == "u" else "down", llm_model,
                sources_data,
            )


def main() -> None:
    try:
        import streamlit  # noqa: F401

        run_streamlit()
    except ImportError:
        run_terminal()


if __name__ == "__main__":
    main()
