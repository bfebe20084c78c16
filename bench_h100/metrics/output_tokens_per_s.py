"""output_tokens_per_s: every token streamed to a client inside the window,
over the window's seconds."""


def read(run: dict):
    if run.get("kind") != "closed_loop":
        return None
    return run["summary"]["output_tokens_per_s"]
