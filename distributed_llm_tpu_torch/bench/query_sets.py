"""Labeled benchmark query sets.

The port's own copy of ``distributed_llm_tpu/bench/query_sets.py`` (the
port imports nothing of the JAX package), record for record.  Same shape
as the reference's evaluation data (src/tests/query_sets.py:1-51): three
named sets, each a list of ``{"query", "expected_device"}`` records,
multi-turn by design (later queries lean on earlier context, which
exercises the context-size routing signals and the ctx-hash cache
keying).  The texts are the JAX package's; the *distribution* mirrors the
reference: simple factual one-liners labeled nano, long, compositional or
code-heavy prompts labeled orin, and technical_coding all-orin.
"""

query_sets = {
    "general_knowledge": [
        {"query": "What is the capital of Japan?", "expected_device": "nano"},
        {"query": "How many continents are there?", "expected_device": "nano"},
        {"query": "Name the largest ocean on Earth.", "expected_device": "nano"},
        {"query": "And the deepest point in it?", "expected_device": "nano"},
        {"query": "What year did the first person walk on the moon?",
         "expected_device": "nano"},
        {"query": "Who was the mission commander?", "expected_device": "nano"},
        {"query": "Explain in detail how plate tectonics drives earthquakes, "
                  "volcanic arcs, and mountain building, and compare the "
                  "mechanisms at divergent, convergent, and transform "
                  "boundaries with concrete examples of each.",
         "expected_device": "orin"},
        {"query": "Write a thorough comparison of the Roman Republic and the "
                  "Roman Empire: institutions, military organization, causes "
                  "of the transition, and the long-term consequences for "
                  "European law and governance.",
         "expected_device": "orin"},
        {"query": "What is photosynthesis?", "expected_device": "nano"},
        {"query": "Given everything we've discussed so far, synthesize a "
                  "short essay connecting lunar exploration, geology, and "
                  "the history of science, citing the earlier answers.",
         "expected_device": "orin"},
        {"query": "Define the word 'ephemeral'.", "expected_device": "nano"},
        {"query": "Why is the sky blue? Why are sunsets red? Why do clouds "
                  "look white? Walk through the scattering physics for each.",
         "expected_device": "orin"},
    ],
    "technical_coding": [
        {"query": "Write a Python function that parses an ISO-8601 timestamp "
                  "without using external libraries and handles timezone "
                  "offsets correctly.", "expected_device": "orin"},
        {"query": "Debug this: my binary search returns the wrong index when "
                  "the target equals the first element. Show the corrected "
                  "loop invariant and explain the off-by-one.",
         "expected_device": "orin"},
        {"query": "Implement an LRU cache with O(1) get and put in C++ using "
                  "a doubly linked list and a hash map; include the class "
                  "definition and eviction logic.", "expected_device": "orin"},
        {"query": "Prove that comparison-based sorting requires Omega(n log n) "
                  "comparisons in the worst case.", "expected_device": "orin"},
        {"query": "Refactor the previous C++ cache to be thread-safe; discuss "
                  "lock granularity and the trade-offs of a sharded design.",
         "expected_device": "orin"},
        {"query": "Write a SQL query that finds the top 3 customers by "
                  "rolling 90-day revenue per region, using window functions.",
         "expected_device": "orin"},
        {"query": "Explain how a B-tree differs from an LSM tree for write-"
                  "heavy workloads and when each wins; include complexity "
                  "analysis and real database examples.",
         "expected_device": "orin"},
        {"query": "Design a rate limiter for a distributed API gateway: token "
                  "bucket vs sliding window, clock skew, and hot-key "
                  "mitigation. Provide pseudocode.", "expected_device": "orin"},
        {"query": "Given a stream of integers, maintain the running median "
                  "with two heaps. Implement it and analyze the complexity.",
         "expected_device": "orin"},
        {"query": "Build a regex that validates RFC-like email addresses and "
                  "explain each component of the pattern.",
         "expected_device": "orin"},
    ],
    "personal_health": [
        {"query": "How much water should I drink per day?",
         "expected_device": "nano"},
        {"query": "Give me one tip to sleep better.", "expected_device": "nano"},
        {"query": "What is a normal resting heart rate?",
         "expected_device": "nano"},
        {"query": "Is mine of 58 bpm okay for an adult who runs regularly?",
         "expected_device": "nano"},
        {"query": "Design a complete 12-week half-marathon training plan for "
                  "a beginner: weekly mileage progression, interval sessions, "
                  "strength work, nutrition guidance, and taper strategy, "
                  "with rationale for each phase.", "expected_device": "orin"},
        {"query": "What does BMI stand for?", "expected_device": "nano"},
        {"query": "Explain in depth how chronic stress affects the immune, "
                  "cardiovascular, and digestive systems, and evaluate the "
                  "evidence behind common interventions like meditation, "
                  "exercise, and therapy.", "expected_device": "orin"},
        {"query": "Suggest a quick healthy snack.", "expected_device": "nano"},
        {"query": "Considering the training plan you outlined earlier, how "
                  "should I adjust the remaining weeks if I miss ten days "
                  "with a cold? Rebuild the schedule and explain the "
                  "physiological reasoning.", "expected_device": "orin"},
        {"query": "What vitamin does sunlight help produce?",
         "expected_device": "nano"},
    ],
}


def _report(title: str, sections: int, opener: str) -> str:
    """Deterministic multi-section pseudo-report used by the long_context
    set.  Sentence material cycles with section-dependent figures so the
    text never literally repeats; size is controlled by ``sections``
    (each ≈ 55 words ≈ 75 BPE tokens under the serving tokenizer)."""
    bodies = [
        ("Throughput reached {n} requests per second during the {i} "
         "window, while the on-call rotation logged {m} pages and the "
         "error budget burned {p} percent."),
        ("The migration moved {n} tables across {m} shards in week {i}; "
         "replication lag peaked at {p} seconds before the backfill "
         "workers caught up."),
        ("Customer interviews in cohort {i} surfaced {n} recurring "
         "complaints, of which {m} trace back to the onboarding flow and "
         "{p} to billing edge cases."),
        ("Cache hit rate settled at {p} percent after the {i} rollout, "
         "cutting origin traffic by {n} gigabytes per day across {m} "
         "regions."),
        ("The audit flagged {n} dependencies with known advisories; {m} "
         "were patched in sprint {i} and the remaining {p} are gated "
         "behind a feature flag."),
        ("Latency at the ninety-ninth percentile improved from {n} to {m} "
         "milliseconds once batch {i} enabled connection pooling, a {p} "
         "percent reduction."),
    ]
    parts = [opener, f"DOCUMENT: {title}."]
    for s in range(sections):
        b = bodies[s % len(bodies)]
        parts.append(
            f"Section {s + 1}. "
            + b.format(n=137 + 7 * s, m=12 + 3 * s, p=5 + (s * 11) % 67,
                       i=f"Q{1 + s % 4}")
            + f" Follow-up item {s + 1} remains owned by team "
            f"{'ABCDEFGH'[s % 8]} pending review.")
    return " ".join(parts)


# The long-context set (round 5): document sizes are chosen so the
# query+context token counts genuinely straddle the reference's
# 100→4000 threshold sweep (src/tests/routing_chatbot_tester.py:352-367
# sweeps token_threshold and BASELINE.md shows load shifting
# continuously across it).  The r4 sweep was degenerate above 500
# because every query was tiny (VERDICT r4 weak #5); these pasted
# documents put successive queries at roughly 0.3k/0.7k/1.2k/2k/3k
# tokens (serving BPE), with short follow-ups riding the accumulated
# context in between.  Serving tiers tail-truncate long prompts to
# max_seq_len exactly like the reference's Ollama window (SURVEY §5.7);
# the ROUTING layer always sees the full text, which is what the sweep
# measures.
query_sets["long_context"] = [
    {"query": "I'm going to paste several status reports; help me work "
              "through them one by one.", "expected_device": "nano"},
    {"query": _report("Edge gateway quarterly review", 4,
                      "Summarize the key risks in this report in three "
                      "bullet points."), "expected_device": "orin"},
    {"query": "Thanks. Which team owns the first follow-up item?",
     "expected_device": "nano"},
    {"query": _report("Payments platform migration postmortem", 9,
                      "Identify the root causes described below and rank "
                      "them by blast radius."), "expected_device": "orin"},
    {"query": "Give me a one-line TL;DR of that last document.",
     "expected_device": "nano"},
    {"query": _report("Search relevance annual audit", 16,
                      "Contrast this audit's findings with the previous "
                      "two documents and flag contradictions."),
     "expected_device": "orin"},
    {"query": "Was replication lag mentioned anywhere? Just yes or no.",
     "expected_device": "nano"},
    {"query": _report("Data warehouse cost retrospective", 27,
                      "Write an executive brief reconciling the spend "
                      "figures below with the earlier reports."),
     "expected_device": "orin"},
    {"query": "Which quarter shows up most often across the documents?",
     "expected_device": "nano"},
    {"query": _report("Mobile release train health check", 40,
                      "Produce a consolidated remediation plan covering "
                      "every document so far, sequenced by dependency."),
     "expected_device": "orin"},
    {"query": "How many documents have I shared with you in total?",
     "expected_device": "nano"},
    {"query": "Now synthesize everything above into a single year-end "
              "narrative for leadership: themes, metrics trajectory, open "
              "risks, and a first-quarter plan, citing specific sections.",
     "expected_device": "orin"},
]
