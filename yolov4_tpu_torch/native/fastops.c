/* fastops: the port's native host code for COCO evaluation.
 *
 *   coco_match:  COCOeval greedy detection<->gt matching (the pycocotools
 *                evaluateImg inner loops) batched over all images of one
 *                (category, area range), OpenMP-parallel over images; the
 *                evaluation's host hot loop. eval/cocoeval.py's
 *                _match_batch_plain is its numpy version.
 *
 * Pure CPython C API; built by native/__init__.py with gcc -O3 -fopenmp at
 * first use, with the numpy version as the fallback on a host without gcc.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef _OPENMP
#include <omp.h>
#endif

static int get_buffer(PyObject *obj, Py_buffer *view, int writable) {
    int flags = PyBUF_C_CONTIGUOUS | (writable ? PyBUF_WRITABLE : 0);
    if (PyObject_GetBuffer(obj, view, flags) != 0) return -1;
    return 0;
}

/* coco_match(ious_f64, g_ignore_u8, iscrowd_u8, d_outside_u8,
 *            nd_i64, ng_i64, thrs_f64, matched_u8_out, ignored_u8_out)
 *
 * COCOeval greedy matching (pycocotools cocoeval.evaluateImg lines 258-282
 * semantics) for all images of one (category, area-range) in one call:
 *   ious      concatenated per-image [D_i, G_i] IoU blocks, dt rows in
 *             descending-score order, gt columns in ORIGINAL ann order
 *   g_ignore  per-gt ignore flag (ann ignore/iscrowd OR area outside range)
 *   iscrowd   per-gt crowd flag (crowd gts may match many detections)
 *   d_outside per-dt "area outside range" flag
 *   nd/ng     per-image detection / gt counts (int64, len = n_images)
 *   thrs      IoU thresholds [T]
 *   matched   out [T, sum(nd)] u8 — detection matched some gt
 *   ignored   out [T, sum(nd)] u8 — matched an ignored gt, or unmatched+outside
 *
 * Within each image the gts are scanned non-ignored-first (stable), a
 * detection takes the available gt with the highest IoU >= thr (ties go to
 * the later gt, matching the reference scan-update order), and the scan
 * stops at the first ignored gt once a non-ignored match is held.
 */
static PyObject *coco_match(PyObject *self, PyObject *args) {
    PyObject *ious_o, *gig_o, *crowd_o, *dout_o, *nd_o, *ng_o, *thrs_o,
             *matched_o, *ignored_o;
    if (!PyArg_ParseTuple(args, "OOOOOOOOO", &ious_o, &gig_o, &crowd_o,
                          &dout_o, &nd_o, &ng_o, &thrs_o, &matched_o,
                          &ignored_o))
        return NULL;
    Py_buffer ious, gig, crowd, dout, nd, ng, thrs, matched, ignored;
    if (get_buffer(ious_o, &ious, 0) != 0) return NULL;
    if (get_buffer(gig_o, &gig, 0) != 0) goto fail1;
    if (get_buffer(crowd_o, &crowd, 0) != 0) goto fail2;
    if (get_buffer(dout_o, &dout, 0) != 0) goto fail3;
    if (get_buffer(nd_o, &nd, 0) != 0) goto fail4;
    if (get_buffer(ng_o, &ng, 0) != 0) goto fail5;
    if (get_buffer(thrs_o, &thrs, 0) != 0) goto fail6;
    if (get_buffer(matched_o, &matched, 1) != 0) goto fail7;
    if (get_buffer(ignored_o, &ignored, 1) != 0) goto fail8;
    {
        const Py_ssize_t n_img = nd.len / (Py_ssize_t)sizeof(int64_t);
        const Py_ssize_t T = thrs.len / (Py_ssize_t)sizeof(double);
        const int64_t *ndp = (const int64_t *)nd.buf;
        const int64_t *ngp = (const int64_t *)ng.buf;
        const double *iou_all = (const double *)ious.buf;
        const uint8_t *gig_all = (const uint8_t *)gig.buf;
        const uint8_t *crowd_all = (const uint8_t *)crowd.buf;
        const uint8_t *dout_all = (const uint8_t *)dout.buf;
        const double *th = (const double *)thrs.buf;
        uint8_t *m_out = (uint8_t *)matched.buf;
        uint8_t *i_out = (uint8_t *)ignored.buf;

        int64_t total_d = 0, total_g = 0, total_iou = 0;
        for (Py_ssize_t i = 0; i < n_img; i++) {
            total_d += ndp[i];
            total_g += ngp[i];
            total_iou += ndp[i] * ngp[i];
        }
        if (gig.len != total_g || crowd.len != total_g || dout.len != total_d ||
            ious.len != total_iou * (Py_ssize_t)sizeof(double) ||
            matched.len != T * total_d || ignored.len != T * total_d ||
            ng.len != n_img * (Py_ssize_t)sizeof(int64_t)) {
            PyBuffer_Release(&ignored); PyBuffer_Release(&matched);
            PyBuffer_Release(&thrs); PyBuffer_Release(&ng); PyBuffer_Release(&nd);
            PyBuffer_Release(&dout); PyBuffer_Release(&crowd);
            PyBuffer_Release(&gig); PyBuffer_Release(&ious);
            PyErr_SetString(PyExc_ValueError, "coco_match: shape mismatch");
            return NULL;
        }

        int64_t *ioff = (int64_t *)malloc(3 * (size_t)(n_img + 1) * sizeof(int64_t));
        int64_t *goff = ioff + (n_img + 1);
        int64_t *doff = goff + (n_img + 1);
        ioff[0] = goff[0] = doff[0] = 0;
        for (Py_ssize_t i = 0; i < n_img; i++) {
            ioff[i + 1] = ioff[i] + ndp[i] * ngp[i];
            goff[i + 1] = goff[i] + ngp[i];
            doff[i + 1] = doff[i] + ndp[i];
        }
        memset(m_out, 0, (size_t)(T * total_d));
        memset(i_out, 0, (size_t)(T * total_d));

        int bad_alloc = 0;
        Py_BEGIN_ALLOW_THREADS
        #pragma omp parallel for schedule(dynamic, 16)
        for (Py_ssize_t i = 0; i < n_img; i++) {
            const int64_t D = ndp[i], G = ngp[i];
            if (D == 0) continue;
            const double *iou = iou_all + ioff[i];
            const uint8_t *gg = gig_all + goff[i];
            const uint8_t *cr = crowd_all + goff[i];
            const uint8_t *do_ = dout_all + doff[i];
            if (G == 0) {  /* no gts: every dt unmatched; outside => ignored */
                for (Py_ssize_t t = 0; t < T; t++) {
                    uint8_t *ir = i_out + (size_t)t * total_d + doff[i];
                    for (int64_t d = 0; d < D; d++) ir[d] = do_[d];
                }
                continue;
            }
            int64_t *ord = (int64_t *)malloc((size_t)G * (sizeof(int64_t) + 1));
            if (!ord) { bad_alloc = 1; continue; }
            uint8_t *taken = (uint8_t *)(ord + G);
            int64_t k = 0;  /* stable: non-ignored gts first */
            for (int64_t g = 0; g < G; g++) if (!gg[g]) ord[k++] = g;
            for (int64_t g = 0; g < G; g++) if (gg[g]) ord[k++] = g;

            for (Py_ssize_t t = 0; t < T; t++) {
                const double thr = th[t] < 1.0 - 1e-10 ? th[t] : 1.0 - 1e-10;
                uint8_t *mr = m_out + (size_t)t * total_d + doff[i];
                uint8_t *ir = i_out + (size_t)t * total_d + doff[i];
                memset(taken, 0, (size_t)G);
                for (int64_t d = 0; d < D; d++) {
                    const double *row = iou + d * G;
                    double best = thr;
                    int64_t m = -1;
                    uint8_t m_ig = 0;
                    for (int64_t gi = 0; gi < G; gi++) {
                        const int64_t g = ord[gi];
                        if (taken[g] && !cr[g]) continue;
                        if (m > -1 && m_ig == 0 && gg[g]) break;
                        const double v = row[g];
                        if (v < best) continue;
                        best = v;
                        m = g;
                        m_ig = gg[g];
                    }
                    if (m < 0) { ir[d] = do_[d]; continue; }
                    mr[d] = 1;
                    ir[d] = m_ig;
                    taken[m] = 1;
                }
            }
            free(ord);
        }
        Py_END_ALLOW_THREADS
        free(ioff);
        if (bad_alloc) {
            PyBuffer_Release(&ignored); PyBuffer_Release(&matched);
            PyBuffer_Release(&thrs); PyBuffer_Release(&ng); PyBuffer_Release(&nd);
            PyBuffer_Release(&dout); PyBuffer_Release(&crowd);
            PyBuffer_Release(&gig); PyBuffer_Release(&ious);
            return PyErr_NoMemory();
        }
    }
    PyBuffer_Release(&ignored); PyBuffer_Release(&matched);
    PyBuffer_Release(&thrs); PyBuffer_Release(&ng); PyBuffer_Release(&nd);
    PyBuffer_Release(&dout); PyBuffer_Release(&crowd);
    PyBuffer_Release(&gig); PyBuffer_Release(&ious);
    Py_RETURN_NONE;
fail8: PyBuffer_Release(&matched);
fail7: PyBuffer_Release(&thrs);
fail6: PyBuffer_Release(&ng);
fail5: PyBuffer_Release(&nd);
fail4: PyBuffer_Release(&dout);
fail3: PyBuffer_Release(&crowd);
fail2: PyBuffer_Release(&gig);
fail1: PyBuffer_Release(&ious);
    return NULL;
}

static PyMethodDef Methods[] = {
    {"coco_match", coco_match, METH_VARARGS, "batched COCOeval matching"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_fastops", "native COCOeval matching",
    -1, Methods,
};

PyMODINIT_FUNC PyInit__fastops(void) { return PyModule_Create(&module); }
