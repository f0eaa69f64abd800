// Native SVG rasterizer / normalizer over librsvg + cairo.
//
// The port's copy of starvector_tpu/native/rasterizer.cpp: a native
// replacement for the reference's cairosvg dependency
// (reference: starvector/data/util.py:138-161 rasterize_svg — svg2png with
// white background and forced output size; :88-117 clean_svg — svg2svg
// normalization). Both cairosvg and this module draw through libcairo, so
// raster output is visually equivalent (same rasterizer core); the SVG
// normalizer renders the document onto a cairo SVG surface exactly like
// cairosvg's svg2svg does.
//
// Implementation notes:
//  * headers for cairo/librsvg are not installed in the image, so the stable
//    C ABIs are declared locally and resolved from the shared libraries the
//    distro ships (librsvg-2.so.2, libcairo.so.2, libgobject-2.0.so.0).
//  * exported functions use a plain C ABI for ctypes consumption.
//  * ARGB32 cairo surfaces are premultiplied BGRA; we paint an opaque white
//    background first (reference background_color='white'), so alpha is 255
//    and RGB bytes can be copied out directly.
//
// Built at first use by starvector_tpu_torch/data/rasterize.py:
// g++ -O2 -Wall -shared -fPIC rasterizer.cpp -o librasterizer_<hash>.so -ldl

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dlfcn.h>

// ---------------------------------------------------------------------------
// minimal ABI declarations
// ---------------------------------------------------------------------------

extern "C" {
typedef struct _cairo cairo_t;
typedef struct _cairo_surface cairo_surface_t;
typedef struct _GError {
  unsigned int domain;
  int code;
  char *message;
} GError;
typedef struct _RsvgHandle RsvgHandle;
typedef struct {
  double x, y, width, height;
} RsvgRectangle;

typedef cairo_surface_t *(*fn_image_surface_create)(int fmt, int w, int h);
typedef int (*fn_write_func)(void *closure, const unsigned char *data,
                             unsigned int length);
typedef cairo_surface_t *(*fn_svg_surface_create_for_stream)(
    fn_write_func write_func, void *closure, double w, double h);
typedef cairo_t *(*fn_cairo_create)(cairo_surface_t *);
typedef void (*fn_cairo_void)(cairo_t *);
typedef void (*fn_cairo_rgb)(cairo_t *, double, double, double);
typedef void (*fn_surface_void)(cairo_surface_t *);
typedef unsigned char *(*fn_get_data)(cairo_surface_t *);
typedef int (*fn_get_stride)(cairo_surface_t *);
typedef int (*fn_surface_status)(cairo_surface_t *);

typedef RsvgHandle *(*fn_rsvg_new_from_data)(const unsigned char *, unsigned long,
                                             GError **);
typedef int (*fn_rsvg_render_document)(RsvgHandle *, cairo_t *,
                                       const RsvgRectangle *, GError **);
typedef void (*fn_rsvg_set_dpi)(RsvgHandle *, double);
typedef int (*fn_rsvg_intrinsic_size)(RsvgHandle *, double *, double *);
typedef void (*fn_g_object_unref)(void *);
typedef void (*fn_g_error_free)(GError *);
}

static const int CAIRO_FORMAT_ARGB32 = 0;

struct Api {
  void *cairo, *rsvg, *gobject;
  fn_image_surface_create image_surface_create;
  fn_svg_surface_create_for_stream svg_surface_create_for_stream;
  fn_cairo_create cr_create;
  fn_cairo_void cr_paint, cr_destroy;
  fn_cairo_rgb cr_set_source_rgb;
  fn_surface_void surface_flush, surface_destroy, surface_finish;
  fn_get_data image_surface_get_data;
  fn_get_stride image_surface_get_stride;
  fn_surface_status surface_status;
  fn_rsvg_new_from_data rsvg_new_from_data;
  fn_rsvg_render_document rsvg_render_document;
  fn_rsvg_set_dpi rsvg_set_dpi;
  fn_rsvg_intrinsic_size rsvg_intrinsic_size;
  fn_g_object_unref g_object_unref;
  fn_g_error_free g_error_free;
  bool ok;
};

static Api *api() {
  // C++11 magic static: the initializer runs exactly once and other
  // threads BLOCK until it finishes — ctypes calls release the GIL, so
  // loader worker threads genuinely race into this function and the old
  // tried/ok handshake could hand out a half-populated table
  static Api *inst = []() -> Api * {
    static Api a;
    a.ok = false;
    a.cairo = dlopen("libcairo.so.2", RTLD_NOW | RTLD_GLOBAL);
  a.gobject = dlopen("libgobject-2.0.so.0", RTLD_NOW | RTLD_GLOBAL);
  a.rsvg = dlopen("librsvg-2.so.2", RTLD_NOW | RTLD_GLOBAL);
  if (!a.cairo || !a.rsvg || !a.gobject) return nullptr;
#define LOAD(lib, name, type, member)                                  \
  a.member = (type)dlsym(a.lib, name);                                 \
  if (!a.member) return nullptr;
  LOAD(cairo, "cairo_image_surface_create", fn_image_surface_create,
       image_surface_create)
  LOAD(cairo, "cairo_svg_surface_create_for_stream",
       fn_svg_surface_create_for_stream, svg_surface_create_for_stream)
  LOAD(cairo, "cairo_create", fn_cairo_create, cr_create)
  LOAD(cairo, "cairo_paint", fn_cairo_void, cr_paint)
  LOAD(cairo, "cairo_destroy", fn_cairo_void, cr_destroy)
  LOAD(cairo, "cairo_set_source_rgb", fn_cairo_rgb, cr_set_source_rgb)
  LOAD(cairo, "cairo_surface_flush", fn_surface_void, surface_flush)
  LOAD(cairo, "cairo_surface_destroy", fn_surface_void, surface_destroy)
  LOAD(cairo, "cairo_surface_finish", fn_surface_void, surface_finish)
  LOAD(cairo, "cairo_image_surface_get_data", fn_get_data,
       image_surface_get_data)
  LOAD(cairo, "cairo_image_surface_get_stride", fn_get_stride,
       image_surface_get_stride)
  LOAD(cairo, "cairo_surface_status", fn_surface_status, surface_status)
  LOAD(rsvg, "rsvg_handle_new_from_data", fn_rsvg_new_from_data,
       rsvg_new_from_data)
  LOAD(rsvg, "rsvg_handle_render_document", fn_rsvg_render_document,
       rsvg_render_document)
  LOAD(rsvg, "rsvg_handle_set_dpi", fn_rsvg_set_dpi, rsvg_set_dpi)
  LOAD(rsvg, "rsvg_handle_get_intrinsic_size_in_pixels", fn_rsvg_intrinsic_size,
       rsvg_intrinsic_size)
  LOAD(gobject, "g_object_unref", fn_g_object_unref, g_object_unref)
  LOAD(gobject, "g_error_free", fn_g_error_free, g_error_free)
#undef LOAD
    a.ok = true;
    return &a;
  }();
  return inst;
}

static void set_err(char *err, size_t errlen, const char *msg) {
  if (err && errlen > 0) {
    strncpy(err, msg, errlen - 1);
    err[errlen - 1] = '\0';
  }
}

extern "C" {

// Render `svg` to an RGB byte buffer (width*height*3), white background.
// Returns 0 on success, nonzero on failure (message in err).
int sv_rasterize(const char *svg, unsigned long svg_len, int width, int height,
                 double dpi, unsigned char *out_rgb, char *err,
                 unsigned long errlen) {
  Api *a = api();
  if (!a) {
    set_err(err, errlen, "librsvg/cairo unavailable");
    return 1;
  }
  GError *gerr = nullptr;
  RsvgHandle *h =
      a->rsvg_new_from_data((const unsigned char *)svg, svg_len, &gerr);
  if (!h) {
    set_err(err, errlen, gerr && gerr->message ? gerr->message : "parse error");
    if (gerr) a->g_error_free(gerr);
    return 2;
  }
  a->rsvg_set_dpi(h, dpi);
  cairo_surface_t *surf =
      a->image_surface_create(CAIRO_FORMAT_ARGB32, width, height);
  if (!surf || a->surface_status(surf) != 0) {
    set_err(err, errlen, "surface alloc failed");
    a->g_object_unref(h);
    return 3;
  }
  cairo_t *cr = a->cr_create(surf);
  // white background (reference background_color='white')
  a->cr_set_source_rgb(cr, 1.0, 1.0, 1.0);
  a->cr_paint(cr);
  RsvgRectangle viewport = {0.0, 0.0, (double)width, (double)height};
  int rok = a->rsvg_render_document(h, cr, &viewport, &gerr);
  a->cr_destroy(cr);
  a->surface_flush(surf);
  if (!rok) {
    set_err(err, errlen,
            gerr && gerr->message ? gerr->message : "render error");
    if (gerr) a->g_error_free(gerr);
    a->surface_destroy(surf);
    a->g_object_unref(h);
    return 4;
  }
  const unsigned char *data = a->image_surface_get_data(surf);
  int stride = a->image_surface_get_stride(surf);
  for (int y = 0; y < height; ++y) {
    const unsigned char *row = data + y * stride;
    unsigned char *out = out_rgb + (unsigned long)y * width * 3;
    for (int x = 0; x < width; ++x) {
      // premultiplied BGRA, alpha is 255 after the opaque white paint
      out[x * 3 + 0] = row[x * 4 + 2];
      out[x * 3 + 1] = row[x * 4 + 1];
      out[x * 3 + 2] = row[x * 4 + 0];
    }
  }
  a->surface_destroy(surf);
  a->g_object_unref(h);
  return 0;
}

struct GrowBuf {
  char *data;
  unsigned long len, cap;
};

static int grow_write(void *closure, const unsigned char *data,
                      unsigned int length) {
  GrowBuf *b = (GrowBuf *)closure;
  if (b->len + length > b->cap) {
    unsigned long ncap = b->cap ? b->cap * 2 : 65536;
    while (ncap < b->len + length) ncap *= 2;
    char *nd = (char *)realloc(b->data, ncap);
    if (!nd) return 11;  // CAIRO_STATUS_WRITE_ERROR
    b->data = nd;
    b->cap = ncap;
  }
  memcpy(b->data + b->len, data, length);
  b->len += length;
  return 0;  // CAIRO_STATUS_SUCCESS
}

// Normalize `svg` by rendering it onto a cairo SVG surface (the svg2svg
// semantics of clean_svg). Output buffer must be freed with sv_free.
int sv_svg2svg(const char *svg, unsigned long svg_len, double out_w,
               double out_h, double dpi, char **out_buf,
               unsigned long *out_len, char *err, unsigned long errlen) {
  Api *a = api();
  if (!a) {
    set_err(err, errlen, "librsvg/cairo unavailable");
    return 1;
  }
  GError *gerr = nullptr;
  RsvgHandle *h =
      a->rsvg_new_from_data((const unsigned char *)svg, svg_len, &gerr);
  if (!h) {
    set_err(err, errlen, gerr && gerr->message ? gerr->message : "parse error");
    if (gerr) a->g_error_free(gerr);
    return 2;
  }
  a->rsvg_set_dpi(h, dpi);
  double w = out_w, hh = out_h;
  if (w <= 0 || hh <= 0) {
    double iw = 0, ih = 0;
    if (a->rsvg_intrinsic_size(h, &iw, &ih) && iw > 0 && ih > 0) {
      w = iw;
      hh = ih;
    } else {
      w = 512;
      hh = 512;
    }
  }
  GrowBuf buf = {nullptr, 0, 0};
  cairo_surface_t *surf =
      a->svg_surface_create_for_stream(grow_write, &buf, w, hh);
  if (!surf || a->surface_status(surf) != 0) {
    set_err(err, errlen, "svg surface alloc failed");
    free(buf.data);
    a->g_object_unref(h);
    return 3;
  }
  cairo_t *cr = a->cr_create(surf);
  RsvgRectangle viewport = {0.0, 0.0, w, hh};
  int rok = a->rsvg_render_document(h, cr, &viewport, &gerr);
  a->cr_destroy(cr);
  a->surface_finish(surf);
  a->surface_destroy(surf);
  a->g_object_unref(h);
  if (!rok) {
    set_err(err, errlen,
            gerr && gerr->message ? gerr->message : "render error");
    if (gerr) a->g_error_free(gerr);
    free(buf.data);
    return 4;
  }
  *out_buf = buf.data;
  *out_len = buf.len;
  return 0;
}

void sv_free(char *buf) { free(buf); }

int sv_available() { return api() != nullptr; }
}
