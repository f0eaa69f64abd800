"""Conversation state for the serving UI (a copy of
starvector_tpu/serve/conversation.py over the port's data/rasterize.py and
data/svg_util.py).

Rebuilds the reference dataclass (reference: starvector/serve/
conversation.py:9-208): message history, image preprocessing policies
(Pad to square with white / Resize), the '<svg' display prompt, and a
time-bounded SVG render helper, with plain-dict messages in place of the
Gradio adapters."""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Any


@dataclasses.dataclass
class Conversation:
    system: str = ""
    roles: tuple[str, str] = ("user", "assistant")
    messages: list[dict] = dataclasses.field(default_factory=list)
    offset: int = 0
    image_process_mode: str = "Pad"  # "Pad" | "Resize" | "Default"
    skip_next: bool = False

    def append_message(self, role: str, content: Any, image=None):
        self.messages.append({"role": role, "content": content, "image": image})

    def get_prompt(self) -> str:
        """The generation trigger (reference image prompt '<svg')."""
        return "<svg"

    def get_images(self, return_pil: bool = True) -> list:
        return [m["image"] for m in self.messages if m.get("image") is not None]

    def process_image(self, image, max_size: int = 1024):
        """Apply the selected resize/pad policy (reference :84-131)."""
        from PIL import Image

        if image.mode == "RGBA":
            bg = Image.new("RGB", image.size, (255, 255, 255))
            bg.paste(image, mask=image.split()[3])
            image = bg
        if self.image_process_mode == "Pad":
            w, h = image.size
            m = max(w, h)
            bg = Image.new("RGB", (m, m), (255, 255, 255))
            bg.paste(image, ((m - w) // 2, (m - h) // 2))
            image = bg
        elif self.image_process_mode == "Resize":
            image = image.resize((336, 336))
        if max(image.size) > max_size:
            scale = max_size / max(image.size)
            image = image.resize(
                (int(image.size[0] * scale), int(image.size[1] * scale))
            )
        return image

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[dict(m) for m in self.messages],
            offset=self.offset,
            image_process_mode=self.image_process_mode,
        )

    def dict(self) -> dict:
        return {
            "system": self.system,
            "roles": list(self.roles),
            "messages": [
                {"role": m["role"], "content": m["content"]}
                for m in self.messages
            ],
            "offset": self.offset,
        }


def render_svg_with_timeout(svg_code: str, timeout: float = 0.1):
    """Render an (possibly partial) SVG within a deadline; None on timeout
    (reference :163-180 ThreadPool render guard)."""
    from starvector_tpu_torch.data.rasterize import rasterize_svg

    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(rasterize_svg, svg_code, 256)
        try:
            return fut.result(timeout=timeout)
        except Exception:
            return None


def close_svg(svg_code: str) -> str:
    """Best-effort closing of unbalanced tags so partial streams render
    (reference gradio_web_server live-render behavior)."""
    from starvector_tpu_torch.data.svg_util import find_unclosed_tags

    out = svg_code
    for tag in reversed(find_unclosed_tags(svg_code)):
        out += f"</{tag}>"
    return out
