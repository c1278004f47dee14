"""Shaders and GL buffer setup for the VR viewer.

Reference: native_viewer/rendering.py:13-237 — a stereo fragment shader that
crops UVs per eye for SBS/OU formats (with eye swap) plus a help-overlay
shader, and interleaved pos3+uv2 VAO/VBO/EBO setup. Shader sources are plain
strings (testable); buffer creation is gated on OpenGL.
"""
from __future__ import annotations

STEREO_VERTEX_SHADER = """
#version 330 core
layout(location = 0) in vec3 in_position;
layout(location = 1) in vec2 in_uv;
uniform mat4 u_mvp;
out vec2 v_uv;
void main() {
    gl_Position = u_mvp * vec4(in_position, 1.0);
    v_uv = in_uv;
}
"""

# stereoFormat: 0=SBS 1=OU 2=anaglyph 3=mono 4=separate
STEREO_FRAGMENT_SHADER = """
#version 330 core
in vec2 v_uv;
uniform sampler2D u_texture;
uniform int u_stereo_format;
uniform int u_eye_index;     // 0 = left, 1 = right
uniform int u_swap_eyes;
out vec4 fragColor;
void main() {
    int eye = (u_swap_eyes == 1) ? (1 - u_eye_index) : u_eye_index;
    vec2 uv = v_uv;
    if (u_stereo_format == 0) {            // side-by-side: crop half width
        uv.x = uv.x * 0.5 + float(eye) * 0.5;
    } else if (u_stereo_format == 1) {     // over-under: crop half height
        uv.y = uv.y * 0.5 + float(eye) * 0.5;
    }                                      // mono/anaglyph: full frame
    fragColor = vec4(texture(u_texture, uv).rgb, 1.0);
}
"""

OVERLAY_VERTEX_SHADER = """
#version 330 core
layout(location = 0) in vec2 in_position;
layout(location = 1) in vec2 in_uv;
out vec2 v_uv;
void main() {
    gl_Position = vec4(in_position, 0.0, 1.0);
    v_uv = in_uv;
}
"""

OVERLAY_FRAGMENT_SHADER = """
#version 330 core
in vec2 v_uv;
uniform sampler2D u_texture;
out vec4 fragColor;
void main() {
    fragColor = texture(u_texture, v_uv);
}
"""


def compile_program(vertex_src: str, fragment_src: str):  # pragma: no cover
    """Compile + link a GL program (requires an active context)."""
    from OpenGL import GL
    from OpenGL.GL import shaders

    vs = shaders.compileShader(vertex_src, GL.GL_VERTEX_SHADER)
    fs = shaders.compileShader(fragment_src, GL.GL_FRAGMENT_SHADER)
    return shaders.compileProgram(vs, fs)


def create_stereo_shaders():  # pragma: no cover
    return compile_program(STEREO_VERTEX_SHADER, STEREO_FRAGMENT_SHADER)


def setup_vao_vbo(vertices, indices):  # pragma: no cover
    """Interleaved [x,y,z,u,v] vertex buffer + element buffer -> VAO."""
    import ctypes

    from OpenGL import GL

    vao = GL.glGenVertexArrays(1)
    GL.glBindVertexArray(vao)
    vbo = GL.glGenBuffers(1)
    GL.glBindBuffer(GL.GL_ARRAY_BUFFER, vbo)
    GL.glBufferData(GL.GL_ARRAY_BUFFER, vertices.nbytes, vertices,
                    GL.GL_STATIC_DRAW)
    ebo = GL.glGenBuffers(1)
    GL.glBindBuffer(GL.GL_ELEMENT_ARRAY_BUFFER, ebo)
    GL.glBufferData(GL.GL_ELEMENT_ARRAY_BUFFER, indices.nbytes, indices,
                    GL.GL_STATIC_DRAW)
    stride = 5 * 4
    GL.glVertexAttribPointer(0, 3, GL.GL_FLOAT, GL.GL_FALSE, stride,
                             ctypes.c_void_p(0))
    GL.glEnableVertexAttribArray(0)
    GL.glVertexAttribPointer(1, 2, GL.GL_FLOAT, GL.GL_FALSE, stride,
                             ctypes.c_void_p(12))
    GL.glEnableVertexAttribArray(1)
    GL.glBindVertexArray(0)
    return vao, vbo, ebo
