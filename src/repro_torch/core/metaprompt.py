"""Meta-prompt construction (paper §2.3, Fig. 1).

The system composes the full prompt from a structured template:

  [STATIC PREFIX — identical across every call for a (model, prompt,
   function, serialization) tuple, so a serving stack can reuse its KV
   prefix across batches ("KV-cache friendly")]
      system instructions
      task: the user prompt text
      output contract (text / JSON / bool / ranking) + formatting rules
  [PER-CALL SUFFIX]
      serialized input tuples (XML — default, JSON, or Markdown)
      output stub

Tuple serialization is deterministic and column-ordered so identical
inputs render identically (prediction-cache hits, dedup).

A copy of ``repro/core/metaprompt.py``; its only difference is this
docstring.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Sequence

SERIALIZATIONS = ("xml", "json", "markdown")

_OUTPUT_CONTRACT = {
    "complete": (
        "Return one line of plain text per input tuple, in order, formatted "
        "as `<id>: <answer>`."),
    "complete_json": (
        "Return one JSON object per input tuple, one per line, formatted as "
        "`<id>: <json>`.  The JSON must follow the schema implied by the "
        "task."),
    "filter": (
        "Return one line per input tuple formatted as `<id>: true` or "
        "`<id>: false`."),
    "reduce": (
        "Return a single text value that aggregates ALL input tuples."),
    "reduce_json": (
        "Return a single JSON object that aggregates ALL input tuples."),
    "rerank": (
        "Return the tuple ids ordered from most to least relevant, as a "
        "comma-separated list, e.g. `3,1,2`."),
    "multi": (
        "Several sub-tasks are listed above, each tagged `t<k> [<kind>]`. "
        "Return one line per input tuple formatted as `<id>: <json>` where "
        "the JSON object has one key per sub-task tag.  filter sub-tasks "
        "map to true/false, complete sub-tasks to a text string, "
        "complete_json sub-tasks to a nested JSON object."),
}


def build_multi_task(sub_kinds: Sequence[str],
                     sub_prompts: Sequence[str]) -> str:
    """Compose the user-prompt for a fused (multi-output) semantic pass.

    Each sub-task renders as ``t<k> [<kind>]: <prompt>`` — the tag doubles
    as the output JSON key, and the ``[<kind>]`` annotation is parseable by
    providers (MockProvider uses it to shape deterministic answers)."""
    lines = ["Perform ALL of the following sub-tasks on every input tuple:"]
    for k, (kind, prompt) in enumerate(zip(sub_kinds, sub_prompts)):
        lines.append(f"t{k} [{kind}]: {prompt}")
    return "\n".join(lines)


def serialize_tuple(tup: dict, fmt: str = "xml") -> str:
    keys = list(tup.keys())
    if fmt == "xml":
        cols = "".join(f"<{k}>{tup[k]}</{k}>" for k in keys)
        return f"<tuple>{cols}</tuple>"
    if fmt == "json":
        return json.dumps({k: tup[k] for k in keys}, sort_keys=False,
                          default=str)
    if fmt == "markdown":
        return "| " + " | ".join(str(tup[k]) for k in keys) + " |"
    raise ValueError(f"unknown serialization {fmt!r}")


def serialize_batch(tuples: Sequence[dict], fmt: str = "xml") -> str:
    lines = []
    if fmt == "markdown" and tuples:
        keys = list(tuples[0].keys())
        lines.append("| id | " + " | ".join(keys) + " |")
        lines.append("|" + "---|" * (len(keys) + 1))
    for i, t in enumerate(tuples):
        if fmt == "markdown":
            lines.append(f"| {i} " + serialize_tuple(t, fmt))
        else:
            lines.append(f'<row id="{i}">{serialize_tuple(t, fmt)}</row>'
                         if fmt == "xml"
                         else json.dumps({"id": i, "tuple": t}, default=str))
    return "\n".join(lines)


@dataclass(frozen=True)
class MetaPrompt:
    """A rendered meta-prompt: static prefix + per-call suffix."""
    prefix: str          # shared across calls -> prefix-KV reusable
    suffix: str          # serialized tuples for this call
    function: str
    serialization: str

    @property
    def text(self) -> str:
        return self.prefix + self.suffix

    def token_estimate(self, tokens_per_char: float = 0.33) -> int:
        return int(len(self.text) * tokens_per_char) + 1


def build_prefix(function: str, user_prompt: str,
                 serialization: str = "xml") -> str:
    contract = _OUTPUT_CONTRACT[function]
    return (
        "You are a semantic SQL function executed inside an analytical "
        "database.  Follow the task exactly; answer only in the requested "
        "format, with no extra commentary.\n"
        f"## Task\n{user_prompt}\n"
        f"## Output contract\n{contract}\n"
        f"## Input serialization\nTuples arrive as {serialization} rows, "
        "each with an integer id.\n"
        "## Input tuples\n")


def build_metaprompt(function: str, user_prompt: str,
                     tuples: Sequence[dict],
                     serialization: str = "xml") -> MetaPrompt:
    if function not in _OUTPUT_CONTRACT:
        raise ValueError(f"unknown function kind {function!r}")
    prefix = build_prefix(function, user_prompt, serialization)
    suffix = serialize_batch(tuples, serialization) + "\n## Answer\n"
    return MetaPrompt(prefix=prefix, suffix=suffix, function=function,
                      serialization=serialization)
